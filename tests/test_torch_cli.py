"""The port's CLI slice on the CPU: ``train.run`` against the JAX CLI's
``train.run`` on one cache, the port's versions of tests/test_cli.py
(resume, run-dir isolation, ``evaluate`` reproducing the training-time eval,
``eval.best``, device-resident data, Brennan's accumulation), ``main()``'s
argv parsing, ``import_torch_checkpoint`` then ``evaluate``, and the demo.

The history comparison runs in f32 at lr 5e-7 with ``d_drop`` 0: the two
frameworks draw different dropout centres, and at a larger lr Adam's ±lr
first step on entries whose gradient is rounding noise moves the losses
apart (``tests/test_torch_trainer.py``'s docstring has the measurements).
Both runs start from the JAX Trainer's initial parameters with the
BatchNorm running statistics moved onto one batch's (from (0, 1) this small
encoder maps every test segment to nearly the same embedding, so every rank
would be a near-tie). The CLIP temperature starts at 1.0, not 5.1: on this
tree's embeddings (cosines 0.06-0.23 between every pair) the JAX CLI's own
f32 loss at 5.1 lies 1.2e-5 relative off its f64 value (its logits 4.3e-4
off at a scale of e^5.1 = 164; the port's 9e-7 and 3.5e-5), above the bound;
at e^1 its rounding falls to ~3e-7. Losses and temperature at rtol 1e-5,
top-k exactly, as ``tests/test_torch_trainer.py`` holds the Trainer. ``evaluate`` against
the training-time eval: loss at rel 1e-4 and top-k at abs 1e-6, the JAX CLI
test's bounds (rel 2e-4 on the device-resident path)."""

import os
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import yaml  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import train as j_train  # noqa: E402
from speech_decoding_tpu.data import synthetic as j_syn  # noqa: E402
from speech_decoding_tpu.data.gwilliams2022 import Gwilliams2022ShallowSplit as JaxShallow  # noqa: E402
from speech_decoding_tpu.training import trainer as j_trainer  # noqa: E402
from speech_decoding_tpu_torch import train as t_train  # noqa: E402
from speech_decoding_tpu_torch.data import synthetic as t_syn  # noqa: E402
from speech_decoding_tpu_torch.data.brennan2018 import Brennan2018Dataset  # noqa: E402
from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022ShallowSplit  # noqa: E402
from speech_decoding_tpu_torch.examples import synthetic_demo  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import load_flax  # noqa: E402
from speech_decoding_tpu_torch.tools.evaluate import evaluate  # noqa: E402
from speech_decoding_tpu_torch.tools.import_torch_checkpoint import import_checkpoint  # noqa: E402

torch.set_num_threads(1)

GW = dict(num_subjects=2, num_sessions=2, num_tasks=2)


def _common(cfg):
    """tests/test_cli.py's overrides: tiny widths, f32, a shared checkpoint
    dir (so a second run resumes)."""
    cfg.epochs, cfg.batch_size, cfg.updates = 2, 4, 3
    cfg.D1, cfg.D2, cfg.K, cfg.F = 16, 16, 4, 16
    cfg.preprocs.last4layers = False  # F=16 (the tiny wav2vec2's feature dim)
    cfg.set_path("tpu.compute_dtype", "float32")
    cfg.set_path("checkpoint.keep", 2)
    cfg.set_path("checkpoint.dir", "checkpoints")
    for k, v in GW.items():
        cfg.set_path(f"gwilliams.{k}", v)
    return cfg


@pytest.fixture(scope="module")
def w2v():
    return t_syn.tiny_wav2vec(device="cpu")


@pytest.fixture(scope="module")
def gw_cache(tmp_path_factory, w2v):
    """A tiny Gwilliams tree with its caches built by the port."""
    root = str(tmp_path_factory.mktemp("gw_cache"))
    t_syn.make_gwilliams_tree(root)
    Gwilliams2022ShallowSplit(_common(t_syn.make_config(root, "Gwilliams2022", rebuild_dataset=True)),
                              wav2vec=w2v, device="cpu", **GW)
    return root


def _fresh(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _close_to_eval(out, hist, loss_rel):
    assert out["epoch"] == hist[-1]["epoch"] and out["test_segments"] > 0
    assert out["test_loss"] == pytest.approx(hist[-1]["test_loss"], rel=loss_rel)
    assert out["testTop1acc"] == pytest.approx(hist[-1]["testTop1acc"], abs=1e-6)
    assert out["testTop10acc"] == pytest.approx(hist[-1]["testTop10acc"], abs=1e-6)


# -- against the JAX CLI -------------------------------------------------------------------


def test_cli_history_matches_jax(tmp_path, monkeypatch):
    """One tiny Gwilliams tree and cache built by the JAX package; its CLI's
    history against the port's ``run(cfg, device="cpu")`` on the same cache
    and the same initial state: 2 epochs of 3 updates (one scanned pair,
    then one step), eval each epoch."""
    root = str(tmp_path)
    j_syn.make_gwilliams_tree(root)
    over = {"lr": 5e-7, "d_drop": 0.0, "init_temperature": 1.0, "tpu.scan_steps": 2, "reproducible": True,
            "seed": 3}
    jcfg, tcfg = (_common(mod.make_config(root, "Gwilliams2022")) for mod in (j_syn, t_syn))
    for cfg, name in ((jcfg, "jax"), (tcfg, "port")):
        for k, v in over.items():
            cfg.set_path(k, v)
        cfg.set_path("checkpoint.dir", os.path.join(root, f"ckpt_{name}"))
    JaxShallow(j_syn.make_config(root, "Gwilliams2022", rebuild_dataset=True, **{"preprocs.last4layers": False}),
               wav2vec=j_syn.tiny_wav2vec(), **GW)

    init = {}
    create = j_trainer.create_train_state

    def capture(encoder, key, X, subject_idxs, **kw):
        st = create(encoder, key, X, subject_idxs, **kw)
        fwd = jax.jit(lambda s: encoder.apply({"params": st.params["encoder"], "batch_stats": s}, X, subject_idxs,
                                              train=True, mutable=["batch_stats"],
                                              rngs={"dropout": jax.random.PRNGKey(0)})[1]["batch_stats"])
        stats = st.batch_stats
        for _ in range(40):
            stats = fwd(stats)
        init["params"] = jax.tree.map(np.asarray, st.params["encoder"])
        init["stats"] = jax.tree.map(np.asarray, stats)
        return st.replace(batch_stats=stats)

    class FromJax:
        @staticmethod
        def from_config(args, loc, num_subjects, generator=None):
            return load_flax(BrainEncoder.from_config(args, loc, num_subjects), init["params"], init["stats"])

    monkeypatch.setattr(j_trainer, "create_train_state", capture)
    jh = j_train.run(jcfg)
    monkeypatch.setattr(t_train, "BrainEncoder", FromJax)
    th = t_train.run(tcfg, device="cpu")
    assert len(jh) == len(th) == 2
    for j, t in zip(jh, th):
        for k in ("train_loss", "test_loss", "temp"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
        for k in ("trainTop1acc", "trainTop10acc", "testTop1acc", "testTop10acc"):
            assert t[k] == j[k], k
    assert tcfg.resolved_seed == jcfg.resolved_seed == 3


# -- the port's CLI tests ----------------------------------------------------------------


def test_gwilliams_cli_resume_isolation_and_evaluate(tmp_path, gw_cache):
    """Train 2 epochs, resume to 3 (one more epoch from the checkpoint),
    ``evaluate`` the latest and the best checkpoint, then a run without
    checkpoint.dir gets its own run dir with a config snapshot that records
    resolved_seed, from which ``evaluate`` rebuilds the split."""
    root = _fresh(gw_cache, tmp_path / "root")
    cfg = _common(t_syn.make_config(root, "Gwilliams2022"))
    hist = t_train.run(cfg, device="cpu")  # records resolved_seed in cfg
    assert [h["epoch"] for h in hist] == [0, 1] and all(np.isfinite(h["train_loss"]) for h in hist)
    assert sorted(os.listdir(os.path.join(root, "checkpoints"))) == ["epoch_0.pt", "epoch_1.pt"]
    cfg2 = cfg.copy()
    cfg2.epochs = 3
    hist2 = t_train.run(cfg2, device="cpu")
    assert [h["epoch"] for h in hist2] == [2]
    assert sorted(os.listdir(os.path.join(root, "checkpoints"))) == ["epoch_1.pt", "epoch_2.pt"]  # keep 2

    out = evaluate(cfg2.copy(), device="cpu")
    assert out["checkpoint_dir"] == os.path.join(root, "checkpoints")
    _close_to_eval(out, hist2, 1e-4)
    best_cfg = cfg2.copy()
    best_cfg.set_path("eval.best", True)
    out_best = evaluate(best_cfg, device="cpu")
    full = hist + hist2
    best = max(h["testTop10acc"] for h in full)
    assert out_best["epoch"] in [h["epoch"] for h in full if h["testTop10acc"] == best]
    assert out_best["testTop10acc"] == pytest.approx(best, abs=1e-6)

    cfg3 = cfg.copy()
    del cfg3["checkpoint"]["dir"]
    cfg3.reproducible = False  # a drawn seed, recorded in the snapshot
    hist3 = t_train.run(cfg3, device="cpu")
    run_dirs = [dp for dp, _, fs in os.walk(os.path.join(root, "outputs")) if "config.yaml" in fs]
    assert len(run_dirs) == 1, run_dirs
    with open(os.path.join(run_dirs[0], "config.yaml")) as f:
        snap = yaml.safe_load(f)
    assert snap["resolved_seed"] == cfg3.resolved_seed
    assert sorted(os.listdir(os.path.join(run_dirs[0], "checkpoints"))) == ["epoch_0.pt", "epoch_1.pt"]
    args = t_train.parse_argv([os.path.join(run_dirs[0], "config.yaml"),
                               f"checkpoint.dir={os.path.join(run_dirs[0], 'checkpoints')}"])
    _close_to_eval(evaluate(args, device="cpu"), hist3, 1e-4)
    lost = cfg3.copy()
    del lost["resolved_seed"]
    lost.set_path("checkpoint.dir", os.path.join(run_dirs[0], "checkpoints"))
    with pytest.raises(ValueError, match="resolved_seed"):
        evaluate(lost, device="cpu")


def test_gwilliams_device_resident(tmp_path, gw_cache):
    """The device-resident path (scan pairs of gathered batches,
    channels-last by the CLI's rule) trains, and ``evaluate`` reproduces the
    training-time eval from host batches in the run's layout."""
    root = _fresh(gw_cache, tmp_path / "root")
    cfg = _common(t_syn.make_config(root, "Gwilliams2022"))
    cfg.set_path("tpu.device_resident_data", True)
    cfg.set_path("tpu.scan_steps", 2)
    cfg.updates = 4
    hist = t_train.run(cfg, device="cpu")
    assert cfg.tpu.channels_last_io is True  # null -> True with device-resident data
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    _close_to_eval(evaluate(cfg.copy(), device="cpu"), hist, 2e-4)
    # an explicit false stays false
    off = cfg.copy()
    off.set_path("tpu.channels_last_io", False)
    off.epochs = 3
    assert [h["epoch"] for h in t_train.run(off, device="cpu")] == [2]
    assert t_train.resolve_channels_last(off) is False


def test_redrawn_test_batch_and_evaluate(tmp_path, gw_cache):
    """``tpu.redraw_test_batch``: epoch N > 0 evaluates on the batch of seed
    + 1 + 1000 N, and ``evaluate`` of that epoch's checkpoint draws it
    again."""
    root = _fresh(gw_cache, tmp_path / "root")
    cfg = _common(t_syn.make_config(root, "Gwilliams2022", **{"tpu.redraw_test_batch": True}))
    hist = t_train.run(cfg, device="cpu")
    _close_to_eval(evaluate(cfg.copy(), device="cpu"), hist, 1e-4)
    first = cfg.copy()
    first.set_path("eval.epoch", 0)
    out = evaluate(first, device="cpu")
    assert out["epoch"] == 0 and out["test_loss"] == pytest.approx(hist[0]["test_loss"], rel=1e-4)


@pytest.mark.parametrize("split_mode", ["sentence", "deep"])
def test_gwilliams_cli_split_modes(tmp_path, gw_cache, split_mode):
    """The sentence and deep splits through the CLI: separate train and test
    datasets (two device-resident batchers), one epoch, and ``evaluate``
    rebuilds the same test set."""
    root = _fresh(gw_cache, tmp_path / "root")
    cfg = _common(t_syn.make_config(root, "Gwilliams2022", split_mode=split_mode, epochs=1,
                                    **{"tpu.device_resident_data": True}))
    hist = t_train.run(cfg, device="cpu")
    assert np.isfinite(hist[0]["train_loss"])
    _close_to_eval(evaluate(cfg.copy(), device="cpu"), hist, 2e-4)


@pytest.mark.parametrize("store", ["bfloat16", "int16"])
def test_gwilliams_cli_device_resident_store_dtypes(tmp_path, gw_cache, store):
    """``tpu.data_dtype`` bfloat16 and int16 stacks train (finite losses)."""
    root = _fresh(gw_cache, tmp_path / "root")
    cfg = _common(t_syn.make_config(root, "Gwilliams2022", epochs=1, **{"tpu.device_resident_data": True,
                                                                        "tpu.data_dtype": store}))
    hist = t_train.run(cfg, device="cpu")
    assert np.isfinite(hist[0]["train_loss"]) and np.isfinite(hist[0]["test_loss"])


def test_brennan_cli_end_to_end(tmp_path, w2v):
    """batch_size 2 -> accumulate_steps 3 (a MultiSteps checkpoint, which
    evaluate restores parameters-only); evaluate the latest and the best."""
    root = str(tmp_path)
    t_syn.make_brennan_tree(root, eeg_secs=30.0, audio_secs=30.0)
    cfg = _common(t_syn.make_config(root, "Brennan2018"))
    cfg.batch_size = 2
    Brennan2018Dataset(t_syn.make_config(root, "Brennan2018", rebuild_dataset=True,
                                         **{"preprocs.last4layers": False}), wav2vec=w2v, device="cpu")
    hist = t_train.run(cfg, device="cpu")
    assert os.listdir(os.path.join(root, "checkpoints"))
    _close_to_eval(evaluate(cfg.copy(), device="cpu"), hist, 1e-4)
    best_cfg = cfg.copy()
    best_cfg.set_path("eval.best", True)
    out = evaluate(best_cfg, device="cpu")
    best = max(h["testTop10acc"] for h in hist)
    assert out["epoch"] in [h["epoch"] for h in hist if h["testTop10acc"] == best]


def test_preemption_drill_through_the_cli(tmp_path, gw_cache):
    """tpu.preempt_after_steps sends a real SIGTERM mid-epoch: the run saves
    and stops after the epoch without eval; a plain rerun resumes at the
    next epoch."""
    root = _fresh(gw_cache, tmp_path / "root")
    cfg = _common(t_syn.make_config(root, "Gwilliams2022"))
    cfg.set_path("tpu.scan_steps", 1)
    drill = cfg.copy()
    drill.set_path("tpu.preempt_after_steps", 2)
    hist = t_train.run(drill, device="cpu")
    assert len(hist) == 1 and "test_loss" not in hist[0]
    assert [h["epoch"] for h in t_train.run(cfg.copy(), device="cpu")] == [1]


def test_main_argv_parsing(tmp_path, monkeypatch):
    """``[config.yaml] key=value ...``: the file first, overrides on top,
    root_dir defaulting to the repository root (not the package's
    directory); main hands the config to run; multihost without
    coordinates and an unknown dataset raise."""
    seen = []
    monkeypatch.setattr(t_train, "run", lambda args, device=None: seen.append(args))
    t_train.main(["dataset=Brennan2018", "lr=1e-3", "tpu.scan_steps=4"])
    args = seen[-1]
    assert (args.dataset, args.lr, args.tpu.scan_steps) == ("Brennan2018", 1e-3, 4)
    assert args.root_dir == ROOT and os.path.isdir(os.path.join(args.root_dir, "speech_decoding_tpu_torch"))
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump({**args.to_dict(), "root_dir": "/elsewhere", "epochs": 7}))
    t_train.main([str(path), "epochs=9"])
    assert (seen[-1].root_dir, seen[-1].epochs, seen[-1].lr) == ("/elsewhere", 9, 1e-3)
    with pytest.raises(ValueError, match="key=value"):
        t_train.parse_argv(["epochs"])
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="tpu.multihost=true but torch.distributed found no coordinates"):
        t_train.run(t_train.parse_argv(["tpu.multihost=true"]), device="cpu")
    with pytest.raises(ValueError, match="Unknown dataset"):
        t_train.run(t_train.parse_argv(["dataset=Other", f"root_dir={tmp_path}"]), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.run(t_train.parse_argv([f"root_dir={tmp_path}"]))


def test_import_torch_checkpoint_then_evaluate(tmp_path, gw_cache):
    """A reference state_dict imported as epoch_0.pt evaluates, through
    checkpoint.dir, to the metrics of evaluating the .pt itself
    (torch_checkpoint=; both f32 encoders, the config's temperature)."""
    from test_torch_models import _reference_state_dict

    root = _fresh(gw_cache, tmp_path / "root")
    sd = _reference_state_dict(np.random.default_rng(3), S_=2, D1=16, D2=16, F_=16, K_=4)
    pt = str(tmp_path / "model_last.pt")
    torch.save(sd, pt)
    out_dir = str(tmp_path / "imported")
    dims = import_checkpoint(pt, out_dir, root_dir=root, device="cpu")
    assert dims == {"S": 2, "D1": 16, "D2": 16, "F": 16, "K": 4}
    assert os.listdir(out_dir) == ["epoch_0.pt"]
    cfg = _common(t_syn.make_config(root, "Gwilliams2022", reproducible=True))  # no run drew a seed
    cfg.set_path("checkpoint.dir", out_dir)
    via_dir = evaluate(cfg.copy(), device="cpu")
    direct = cfg.copy()
    direct.set_path("torch_checkpoint", pt)
    via_pt = evaluate(direct, device="cpu")
    assert via_dir["epoch"] == 0 and via_pt["epoch"] is None
    for k in ("test_loss", "testTop1acc", "testTop10acc", "test_segments"):
        assert np.isfinite(via_dir[k]) and via_dir[k] == pytest.approx(via_pt[k], rel=1e-6, abs=1e-7), k
    with pytest.raises(ValueError, match="subjects"):
        bad = _reference_state_dict(np.random.default_rng(4), S_=3, D1=16, D2=16, F_=16, K_=4)
        torch.save(bad, pt)
        evaluate(direct, device="cpu")


def test_demo_runs_tiny_on_the_cpu(tmp_path):
    out = synthetic_demo.main(str(tmp_path), device="cpu")
    assert len(out["history"]) == 3 and all(np.isfinite(h["train_loss"]) for h in out["history"])
    assert out["bank_shape"] == (6, 16, 360) and out["stream_windows"] == 7
    assert out["stream_ids"].shape == (7, 3) and out["stream_ids"].max() < 6


@pytest.mark.slow
def test_flagship_width_cli_step_on_the_cpu(tmp_path, w2v):
    """The CLI at the flagship widths (D1 270, D2 320, K 32, F 1024 from
    last4layers, B 64, bf16 compute) for one update and its eval, on a
    tree of 3 subjects: finite losses."""
    root = str(tmp_path)
    t_syn.make_gwilliams_tree(root, n_subjects=3, n_sessions=1, n_tasks=1, rec_secs=40.0, n_words_per_task=100)
    from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2

    cfg = t_syn.make_config(root, "Gwilliams2022", epochs=1, updates=1, **{
        "gwilliams.num_subjects": 3, "gwilliams.num_sessions": 1, "gwilliams.num_tasks": 1,
        "checkpoint.dir": "ckpt", "tpu.device_resident_data": True})
    big = FrozenWav2Vec2(Wav2Vec2Model(Wav2Vec2Config(**{**t_syn.TINY_WAV2VEC, "hidden_size": 1024,
                                                         "num_attention_heads": 16})), device="cpu")
    Gwilliams2022ShallowSplit(t_syn.make_config(root, "Gwilliams2022", rebuild_dataset=True), wav2vec=big,
                              device="cpu", num_subjects=3, num_sessions=1, num_tasks=1)
    hist = t_train.run(cfg, device="cpu")
    assert np.isfinite(hist[0]["train_loss"]) and np.isfinite(hist[0]["test_loss"])
