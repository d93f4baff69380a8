"""The port's training loop on the CPU, mirroring tests/test_train.py:
preemption mid-epoch and resume, the guard's SIGTERM round trip, the
multi-process agreement cadence, scan mode, fused blocks, checkpoints
(keep, best under ``-best``, cadence, MultiSteps), sampling against the JAX
package's, the Prefetcher, seeding, ``SpeechDecoder.from_checkpoint``, the
serve CLI's ``checkpoint.dir`` and the scale run at a small width."""

import os
import signal

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from speech_decoding_tpu.data import sampling as jsampling  # noqa: E402
from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.data import sampling  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.data.native_loader import Prefetcher  # noqa: E402
from speech_decoding_tpu_torch.inference import SpeechDecoder  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.training import (  # noqa: E402
    CheckpointManager, PreemptionGuard, Trainer, create_train_state, make_train_step,
)
from speech_decoding_tpu_torch.training.state import MultiSteps  # noqa: E402
from speech_decoding_tpu_torch.utils.reproducibility import seed_everything  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, D1, D2, F, K, B, T, C = 2, 8, 8, 16, 2, 8, 24, 208
LOC = ch_locations_2d("Gwilliams2022", cache=False)


def _encoder(seed=0):
    return BrainEncoder(num_subjects=S, loc=LOC, D1=D1, D2=D2, F=F, K=K,
                        generator=torch.Generator().manual_seed(seed))


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return {"X": rng.normal(size=(b, C, T)).astype(np.float32), "Y": rng.normal(size=(b, F, T)).astype(np.float32),
            "subject_idxs": rng.integers(0, S, b).astype(np.int32)}


def _cfg(**overrides):
    cfg = load_config()
    for path, value in {"tpu.compute_dtype": "float32", "tpu.scan_steps": 1, "epochs": 1, **overrides}.items():
        cfg.set_path(path, value)
    return cfg


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (na, ta), (nb, tb) in zip(a.encoder.state_dict().items(), b.encoder.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na
    assert torch.equal(a.clip.temp, b.clip.temp)
    oa, ob = a.optimizer, b.optimizer
    if isinstance(oa, MultiSteps):
        assert oa.mini_step == ob.mini_step and all(torch.equal(x, y) for x, y in zip(oa._acc, ob._acc))
        oa, ob = oa.optimizer, ob.optimizer
    sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# -- the Trainer ---------------------------------------------------------------------------


def test_preemption_mid_epoch_checkpoint(tmp_path):
    """A preemption request between dispatches stops the epoch, skips eval,
    force-saves the mid-epoch state (bypassing every_epochs=100), and a
    fresh Trainer (another initialization) resumes at epoch 1 with step 2,
    its parameters, statistics and Adam moments bitwise equal."""
    batch = _batch()
    ckpts = CheckpointManager(str(tmp_path / "ck"), every_epochs=100)
    trainer = Trainer(_encoder(0), _cfg(), checkpoints=ckpts, device="cpu")
    # not installed (no signal handler): step_tick flags directly after 2 steps
    trainer.preemption = PreemptionGuard(inject_after_steps=2)
    out = trainer.run_epoch(0, [dict(batch) for _ in range(6)], batch)
    assert trainer.preempted
    assert "test_loss" not in out and np.isfinite(out["train_loss"])
    assert trainer.state.step == 2
    ckpts.wait()
    assert ckpts.latest_epoch() == 0
    trainer2 = Trainer(_encoder(1), _cfg(), checkpoints=ckpts, device="cpu")
    assert trainer2.start_epoch == 1
    _assert_states_equal(trainer.state, trainer2.state)


def test_preemption_guard_signal_roundtrip():
    """An installed guard turns a real SIGTERM into a flag (the process
    survives) and uninstall restores the previous handler."""
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested
    assert signal.getsignal(signal.SIGTERM) is before


def test_preempt_multihost_agreement_cadence():
    """The agreement fires even when epochs are shorter than the sync
    cadence: the dispatch counter is monotonic across epochs and the
    epoch-end sync point forces a check (no process group: the local flag
    is the agreement)."""
    batch = _batch()

    def flagged_trainer():
        t = Trainer(_encoder(), _cfg(), batch, device="cpu")
        t.multihost = True
        t.preemption = PreemptionGuard()
        t.preemption.request()
        return t

    t = flagged_trainer()
    for _ in range(3):
        assert not t._preempt_check()  # below the cadence: deferred
    assert t._preempt_check(sync=True)
    assert t.preempted
    t = flagged_trainer()
    for _ in range(24):
        assert not t._preempt_check()
    assert t._preempt_check()  # dispatch 25
    assert t.preempted


def test_trainer_scan_mode_epoch():
    """tpu.scan_steps=2 over 5 batches: 2 scanned pairs and 1 remainder, 5
    optimizer steps and 5 metric entries: the epoch equals 5 single steps
    bit for bit (the same masks, keyed by step)."""
    batches = [_batch(i) for i in range(5)]
    outs, states = [], []
    for scan in (2, 1):
        t = Trainer(_encoder(), _cfg(**{"tpu.scan_steps": scan}), device="cpu")
        outs.append(t.run_epoch(0, [dict(b) for b in batches], None))
        states.append(t.state)
    assert states[0].step == 5
    assert outs[0]["train_loss"] == outs[1]["train_loss"] and outs[0]["temp"] == outs[1]["temp"]
    _assert_states_equal(*states)


def test_trainer_fused_blocks_on_the_cpu():
    """tpu.fused_train_blocks runs K6's plain stages on the CPU (JAX ignores
    the key off a TPU): the same function as the module blocks (loss and
    temperature at rtol 1e-5, sums in another order)."""
    batches = [_batch(i) for i in range(2)]
    outs = [Trainer(_encoder(), _cfg(**{"tpu.fused_train_blocks": fused}), device="cpu")
            .run_epoch(0, [dict(b) for b in batches], None) for fused in (False, True)]
    for k in ("train_loss", "temp"):
        np.testing.assert_allclose(outs[1][k], outs[0][k], rtol=1e-5, err_msg=k)


def test_trainer_dropout_masks_follow_the_step():
    """The mask of a step depends on (seed, step) only, so a resumed run
    draws what an uninterrupted one would; steps draw different centres."""
    a, b = (Trainer(_encoder(), _cfg(), device="cpu") for _ in range(2))
    assert torch.equal(a._step_mask(7), b._step_mask(7))
    masks = {tuple(a._step_mask(s).tolist()) for s in range(8)}
    assert len(masks) > 1 and all(0 < sum(m) < C for m in masks)


def test_trainer_batches_and_refusals():
    t = Trainer(_encoder(), _cfg(), device="cpu")
    X = torch.zeros(2, 3)
    put = t._put({"X": X, "Y": np.ones((2, 4), np.float32), "subject_idxs": np.array([1, 0], np.int64)})
    assert put["X"] is X  # already on the state's device: untouched
    assert put["Y"].dtype == torch.float32 and put["subject_idxs"].dtype == torch.int32
    # no process group: one rank of its own, the primary (the data-parallel
    # Trainer is tests/test_torch_multihost.py's)
    assert t.group is None and not t.multihost and t.is_primary
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(_encoder(), _cfg())


# -- checkpoints ------------------------------------------------------------------------------


def _stepped_state(seed=0, steps=1, accumulate_steps=1):
    st = create_train_state(_encoder(seed), lr=1e-3, accumulate_steps=accumulate_steps, device="cpu")
    step = make_train_step()
    mask = torch.ones(C)
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        st, _ = step(st, b, drop_mask=mask)
    return st


def test_checkpoint_keep_cadence_and_atomic_names(tmp_path):
    st = _stepped_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, every_epochs=2)
    for ep in range(6):
        mgr.save(ep, st)
    assert mgr._epochs(mgr.directory) == [2, 4]  # cadence 2, the 2 newest kept
    mgr.save(5, st, force=True)
    assert mgr.latest_epoch() == 5 and mgr._epochs(mgr.directory) == [4, 5]
    open(os.path.join(mgr.directory, "epoch_9.pt.tmp123"), "wb").close()  # a killed save's leftover
    assert mgr.latest_epoch() == 5 and mgr.best_epoch() is None
    with pytest.raises(ValueError, match="track_metric"):
        mgr.restore(st, best=True)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(st)
    with pytest.raises(ValueError, match="track_mode"):
        CheckpointManager(str(tmp_path / "x"), track_metric="a", track_mode="up")


@pytest.mark.parametrize("mode,values,best", [("max", [0.2, 0.5, 0.5, 0.3], 2), ("min", [3.0, 1.0, 2.0, 1.5], 1)])
def test_checkpoint_best_model(tmp_path, mode, values, best):
    """The best checkpoint lives in the sibling <dir>-best/, one file, the
    newer epoch winning a tie (as orbax keeps it); restore(best=True) loads
    it."""
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=1, track_metric="m", track_mode=mode)
    states = {}
    for ep, v in enumerate(values):
        states[ep] = _stepped_state(seed=ep)
        mgr.save(ep, states[ep], extra={"m": v})
    assert mgr.best_directory == mgr.directory + "-best" and os.path.isdir(mgr.best_directory)
    assert mgr.best_epoch() == best and mgr._epochs(mgr.best_directory) == [best]
    assert mgr.latest_epoch() == len(values) - 1
    st, ep = mgr.restore(_stepped_state(seed=9), best=True)
    assert ep == best
    _assert_states_equal(st, states[best])
    reopened = CheckpointManager(mgr.directory, track_metric="m", track_mode=mode)  # the held metric from its file
    reopened.save(len(values), states[0], extra={"m": values[best]})  # a tie: the newer epoch wins
    assert reopened.best_epoch() == len(values)


def test_checkpoint_multisteps(tmp_path):
    """A MultiSteps state saved mid-accumulation (2 of 3 mini-steps) and
    restored into a fresh state steps exactly as the uninterrupted one; its
    checkpoint restores for eval into a plain-Adam state (parameters,
    statistics, temperature, step), while a full restore refuses it."""
    a = _stepped_state(steps=2, accumulate_steps=3)
    assert isinstance(a.optimizer, MultiSteps) and a.optimizer.mini_step == 2
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, a)
    b, _ = mgr.restore(_stepped_state(seed=5, steps=0, accumulate_steps=3))
    assert b.optimizer.mini_step == 2
    before = {k: v.clone() for k, v in a.encoder.named_parameters()}
    step, mask = make_train_step(), torch.ones(C)
    batch = {k: torch.from_numpy(v) for k, v in _batch(7).items()}
    for st in (a, b):
        step(st, batch, drop_mask=mask)
    _assert_states_equal(a, b)
    assert any(not torch.equal(p, before[k]) for k, p in a.encoder.named_parameters())  # the 3rd call stepped
    adam = create_train_state(_encoder(3), device="cpu")
    ev, _ = mgr.restore_for_eval(adam)
    assert isinstance(ev.optimizer, torch.optim.Adam) and ev.step == 2
    for (n, p), q in zip(ev.encoder.state_dict().items(), torch.load(mgr._path(mgr.directory, 0))["encoder"].values()):
        assert torch.equal(p, q), n
    with pytest.raises((KeyError, ValueError)):
        mgr.restore(create_train_state(_encoder(3), device="cpu"))


# -- data ---------------------------------------------------------------------------------------


def test_sampling_matches_jax():
    """The same np.random.Generator gives the same ids as the JAX package."""
    for mod_a, mod_b in ((sampling, jsampling),):
        r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
        for a, b in zip(mod_a.random_split(50, 0.8, r1), mod_b.random_split(50, 0.8, r2)):
            np.testing.assert_array_equal(a, b)
        pool = np.arange(100, 140)
        for a, b in zip(mod_a.iter_updates_batches(pool, 8, 5, r1), mod_b.iter_updates_batches(pool, 8, 5, r2)):
            np.testing.assert_array_equal(a, b)
            assert len(set(a.tolist())) == 8
        for drop_last in (False, True):
            got = list(mod_a.iter_shuffled_batches(pool, 7, r1, drop_last))
            want = list(mod_b.iter_shuffled_batches(pool, 7, r2, drop_last))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cannot fill"):
        next(sampling.iter_updates_batches([1, 2], 3, 1, np.random.default_rng(0)))


def test_prefetcher_order_errors_and_close():
    assert list(Prefetcher(iter(range(20)), transform=lambda x: x * 2, depth=3)) == [2 * i for i in range(20)]

    def failing():
        yield 1
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for item in Prefetcher(failing()):
            got.append(item)
    assert got == [1]

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = Prefetcher(endless(), depth=2)
    it = iter(pf)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive(), "the producer thread did not stop"
    pf = Prefetcher(endless(), depth=2)
    for i in pf:  # leaving the loop early stops the producer too
        if i == 4:
            break
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


def test_seed_everything():
    g = seed_everything(5)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    g = seed_everything(5)
    assert a == (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    assert g.device.type == "cpu"


# -- serving a checkpoint --------------------------------------------------------------------------


def _serve_cfg(ckpt_dir, **extra):
    return load_config(None, [f"root_dir={ROOT}", f"checkpoint.dir={ckpt_dir}", "serve.num_subjects=2", f"D1={D1}",
                              f"D2={D2}", f"K={K}", f"F={F}", "preprocs.last4layers=false",
                              "tpu.compute_dtype=float32", *[f"{k}={v}" for k, v in extra.items()]])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of a small Trainer with checkpoints (keep 3, best by
    testTop10acc) and the encoder's state after each epoch."""
    from speech_decoding_tpu_torch import serve

    d = str(tmp_path_factory.mktemp("serve") / "ck")
    args = _serve_cfg(d)
    enc = BrainEncoder.from_config(args, ch_locations_2d(args.dataset, args.root_dir), 2,
                                   generator=torch.Generator().manual_seed(0))
    mgr = CheckpointManager(d, keep=3, track_metric="testTop10acc")
    t = Trainer(enc, _cfg(), checkpoints=mgr, device="cpu")
    test = _batch(50, b=16)
    snaps = []
    for ep in range(2):
        t.run_epoch(ep, [_batch(ep * 10 + i) for i in range(3)], test)
        snaps.append({k: v.clone() for k, v in t.state.encoder.state_dict().items()})
    return serve, d, mgr, t, snaps, test


def _decoder_from(snap, args):
    enc = BrainEncoder.from_config(args, ch_locations_2d(args.dataset, args.root_dir), 2)
    enc.load_state_dict(snap)
    return SpeechDecoder(enc, device="cpu")


def test_from_checkpoint_equals_the_trained_encoder(trained):
    """ids exact, scores within 1e-6, for the latest checkpoint and the best."""
    serve, d, mgr, t, snaps, test = trained
    args = _serve_cfg(d)
    for kw, snap in (({}, snaps[-1]), ({"best": True}, snaps[mgr.best_epoch()]), ({"epoch": 0}, snaps[0])):
        fresh = BrainEncoder.from_config(args, ch_locations_2d(args.dataset, args.root_dir), 2)
        got = SpeechDecoder.from_checkpoint(d, fresh, bank=test["Y"], device="cpu", **kw)
        want = _decoder_from(snap, args)
        want.set_bank(test["Y"])
        s1, i1 = got.decode(test["X"], test["subject_idxs"], k=5)
        s2, i2 = want.decode(test["X"], test["subject_idxs"], k=5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra,which", [({}, "latest"), ({"eval.best": "true"}, "best"), ({"eval.epoch": 0}, 0)])
def test_serve_build_decoder_from_checkpoint_dir(trained, extra, which):
    serve, d, mgr, t, snaps, test = trained
    args = _serve_cfg(os.path.relpath(d, ROOT), **extra)  # a relative dir resolves against root_dir
    dec = serve.build_decoder(args, device="cpu")
    snap = snaps[{"latest": -1, "best": mgr.best_epoch(), 0: 0}[which]]
    for name, v in dec.encoder.state_dict().items():
        assert torch.equal(v, snap[name]), name
    with pytest.raises(ValueError, match="checkpoint.dir"):
        serve.build_decoder(load_config(None, [f"root_dir={ROOT}"]), device="cpu")


# -- the scale run -------------------------------------------------------------------------------------


def test_scale_run_small_writes_no_file(tmp_path):
    """The scale run's loop at a small width on the CPU: the summary, the
    learning gate's keys, checkpoints only where pointed, no file in the
    repository."""
    from speech_decoding_tpu_torch.tools import scale_run

    before = {f: os.stat(os.path.join(ROOT, f)).st_mtime_ns for f in os.listdir(ROOT)}
    dims = {"B": 8, "C": 208, "T": 24, "F": 16, "S": 3, "D1": 8, "D2": 8, "K": 2}
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, track_metric="testTop10acc")
    summary, trainer, world = scale_run.run(2, 12, 24, device="cpu", checkpoints=mgr, dims=dims)
    assert trainer.state.step == 24 and len(trainer.history) == 2  # a scan group of 8, then 4 single steps
    assert set(summary["gate"]) == {"heldout_top10_over_2x_chance", "train_loss_fell_10pct"}
    assert summary["chance_top10"] == 10 / 64 and summary["device"] == "cpu"
    assert world.X.shape == (24 + 64, 24, 208) and world.X.dtype == torch.bfloat16
    assert mgr.latest_epoch() == 1 and mgr.best_epoch() is not None
    after = {f: os.stat(os.path.join(ROOT, f)).st_mtime_ns for f in os.listdir(ROOT)}
    assert after == before
