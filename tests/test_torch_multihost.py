"""Multi-process training in the port, on the CPU: two gloo ranks spawned as
fresh processes (``parallel.multihost.spawn_ranks``), mirroring
``tests/test_multihost.py``:

  * the Trainer (``test_two_process_training_matches_single_process``):
    each rank passes its block of the same global batches (one step at a
    time, scan groups of two, and the fused blocks); its history equals the
    one-process Trainer's on the global batches (losses and temperature at
    rtol 1e-5, top-k exactly), the segment count is global, and the state
    is bit-identical across ranks;
  * symmetric checkpointing (``test_two_process_symmetric_checkpointing``):
    every rank saves, the primary writes, every rank resumes the same
    state, a single process restores the file; a manager on one rank only
    raises on both; a preemption requested on one rank stops both at the
    same step and saves;
  * the CLI (``test_cli_two_process_end_to_end``): ``train.run`` with
    ``tpu.multihost=true`` from torchrun's variables, each rank with a
    seed of its own (rank 0's broadcast), a shared ``checkpoint.dir``; both
    ranks log the same history, which equals a one-process run on that
    seed (its test top-k aside: near-ties, see the test);
  * every fail-loudly case of ``maybe_init_distributed`` and the global
    sampling draws, under torchrun's variable names.

f32, one thread a process, tiny widths. The histories are compared at lr
5e-7, as ``tests/test_torch_trainer.py`` compares the Trainer with JAX's:
the entries whose gradient is zero in exact arithmetic (the conv biases
ahead of a batch-stat BN) hold rounding noise that differs between one
process and two, and Adam's first steps turn it into ±lr per entry, which
the eval-mode BatchNorm passes on to the test loss (at lr 1e-3 it moved
the test loss by 4e-5 relative after three steps)."""

import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.data import synthetic as t_syn  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.parallel import data_group  # noqa: E402
from speech_decoding_tpu_torch.parallel import multihost  # noqa: E402
from speech_decoding_tpu_torch.parallel.multihost import (  # noqa: E402
    free_port,
    host_local_slice,
    local_batch,
    maybe_init_distributed,
    spawn_ranks,
)
from speech_decoding_tpu_torch.training import CheckpointManager, PreemptionGuard, Trainer  # noqa: E402
from speech_decoding_tpu_torch.training.state import create_train_state, state_digest  # noqa: E402

torch.set_num_threads(1)

B, C, T, F, S = 8, 208, 60, 64, 2
VARIANTS = {"single": {}, "scan": {"tpu.scan_steps": 2}, "fused": {"tpu.fused_train_blocks": True}}
GW = dict(num_subjects=2, num_sessions=2, num_tasks=2)


def _batches(n=4):
    """n global batches; the last is the test batch."""
    rng = np.random.default_rng(0)
    return [{"X": rng.normal(size=(B, C, T)).astype(np.float32), "Y": rng.normal(size=(B, F, T)).astype(np.float32),
             "subject_idxs": (np.arange(B) % S).astype(np.int32)} for _ in range(n)]


def _encoder():
    return BrainEncoder(num_subjects=S, loc=ch_locations_2d("Gwilliams2022", cache=False), D1=16, D2=24, F=F, K=4,
                        d_drop=0.05, generator=torch.Generator().manual_seed(0))


def _cfg(**overrides):
    cfg = load_config()
    for path, value in {"tpu.compute_dtype": "float32", "tpu.scan_steps": 1, "epochs": 1, "lr": 5e-7,
                        **overrides}.items():
        cfg.set_path(path, value)
    return cfg


def _epoch(trainer, train, test):
    out = trainer.run_epoch(0, [dict(b) for b in train], test)
    out["segments"] = out["train_segments_per_sec"] * trainer.last_epoch_seconds["train"]
    return out


# -- the ranks ------------------------------------------------------------------------------------


def _rank_trainers(root):
    group = data_group("cpu")
    *train, test = _batches()
    local = [{k: v[host_local_slice(B)] for k, v in b.items()} for b in train]
    out = {}
    for name, over in VARIANTS.items():
        tr = Trainer(_encoder(), _cfg(**over), device="cpu")
        assert tr.multihost and tr.group.world == 2 and tr.is_primary == (group.rank == 0)
        out[name] = {"hist": _epoch(tr, local, test), "digest": state_digest(tr.state), "step": tr.state.step}

    # symmetric checkpoints: every rank saves, the primary writes, every rank resumes
    shared = os.path.join(root, "shared_ckpts")
    tr = Trainer(_encoder(), _cfg(), device="cpu", checkpoints=CheckpointManager(shared, track_metric="testTop10acc"))
    _epoch(tr, local, test)
    resumed = Trainer(_encoder(), _cfg(), device="cpu", checkpoints=CheckpointManager(shared))
    out["checkpoint"] = {"start_epoch": resumed.start_epoch, "digest": state_digest(tr.state),
                         "resumed_same": state_digest(resumed.state) == state_digest(tr.state)}
    try:
        Trainer(_encoder(), _cfg(), device="cpu",
                checkpoints=CheckpointManager(os.path.join(root, "lonely")) if group.rank == 0 else None)
        out["asymmetric"] = "no error"
    except RuntimeError as e:
        out["asymmetric"] = str(e)

    # ranks whose encoders start apart (rank-dependent seeds) are refused
    # by the initial-state check, on both ranks at once
    try:
        Trainer(BrainEncoder(num_subjects=S, loc=ch_locations_2d("Gwilliams2022", cache=False), D1=16, D2=24, F=F,
                             K=4, generator=torch.Generator().manual_seed(group.rank)), _cfg(), device="cpu")
        out["apart"] = "no error"
    except RuntimeError as e:
        out["apart"] = str(e)

    # a preemption requested on rank 1 only: the agreement stops both ranks
    # at the same dispatch, and both enter the save
    tr = Trainer(_encoder(), _cfg(**{"tpu.preempt_sync_every": 1}), device="cpu",
                 checkpoints=CheckpointManager(os.path.join(root, "preempt")))
    tr.preemption = PreemptionGuard()
    if group.rank == 1:
        tr.preemption.request()
    hist = tr.run_epoch(0, [dict(b) for b in local], test)
    out["preempt"] = {"step": tr.state.step, "preempted": tr.preempted, "evaluated": "test_loss" in hist,
                      "saved": tr.checkpoints.latest_epoch(), "digest": state_digest(tr.state)}
    return out


def _rank_cli(root, port):
    """train.run as torchrun would start it: the launcher's group is torn
    down and the CLI initializes its own from the environment."""
    from speech_decoding_tpu_torch import train as t_train

    dist.destroy_process_group()
    os.environ["MASTER_PORT"] = str(port)
    cfg = _cli_cfg(root)
    # each rank resolves a seed of its own (as reproducible=false draws one
    # from OS entropy): rank 0's must win
    cfg.reproducible = False
    cfg.set_path("resolved_seed", 11 + 11 * int(os.environ["RANK"]))
    cfg.set_path("tpu.multihost", True)
    cfg.set_path("checkpoint.dir", os.path.join(root, "shared_ckpts"))
    hist = t_train.run(cfg, device="cpu")
    return {"hist": hist, "seed": int(cfg.resolved_seed), "world": dist.get_world_size(),
            "rank": dist.get_rank()}


def _cli_cfg(root):
    cfg = t_syn.make_config(root, "Gwilliams2022")
    cfg.epochs, cfg.batch_size, cfg.updates, cfg.lr = 2, 4, 3, 5e-7
    cfg.D1, cfg.D2, cfg.K, cfg.F = 16, 16, 4, 16
    cfg.preprocs.last4layers = False
    cfg.set_path("tpu.compute_dtype", "float32")
    cfg.set_path("tpu.scan_steps", 1)
    cfg.split_mode = "shallow"
    for k, v in GW.items():
        cfg.set_path(f"gwilliams.{k}", v)
    return cfg


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh"))
    return root, spawn_ranks(_rank_trainers, 2, args=(root,), torch_threads=1, timeout=300)


def _assert_history(got, want, test_topk=True):
    for k in ("train_loss", "test_loss", "temp"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for k in ("trainTop1acc", "trainTop10acc") + (("testTop1acc", "testTop10acc") if test_topk else ()):
        assert got[k] == want[k], k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_process_training_matches_single_process(trainer_runs, variant):
    _, ranks = trainer_runs
    r0, r1 = (r[variant] for r in ranks)
    assert r0["hist"] == {**r1["hist"], "train_segments_per_sec": r0["hist"]["train_segments_per_sec"],
                          "segments": r0["hist"]["segments"]}  # the same global metrics on both ranks
    assert r0["digest"] == r1["digest"] and r0["step"] == 3
    *train, test = _batches()
    one = Trainer(_encoder(), _cfg(**VARIANTS[variant]), device="cpu")
    want = _epoch(one, train, test)
    _assert_history(r0["hist"], want)
    for r in (r0, r1):
        assert r["hist"]["segments"] == pytest.approx(3 * B, rel=1e-6)  # global rows, not the rank's


def test_two_process_symmetric_checkpointing(trainer_runs):
    root, ranks = trainer_runs
    for r in ranks:
        ck = r["checkpoint"]
        assert ck["start_epoch"] == 1 and ck["resumed_same"] and ck["digest"] == ranks[0]["checkpoint"]["digest"]
        assert "checkpointing must be symmetric" in r["asymmetric"]
        assert "the initial train state differs between the ranks" in r["apart"]
    mgr = CheckpointManager(os.path.join(root, "shared_ckpts"), track_metric="testTop10acc")
    assert mgr.latest_epoch() == 0 and mgr.best_epoch() == 0
    assert sorted(os.listdir(mgr.directory)) == ["epoch_0.pt"]  # one writer, no stray temporary file
    state, epoch = mgr.restore(create_train_state(_encoder(), device="cpu"))
    assert epoch == 0 and state.step == 3
    assert state_digest(state) == ranks[0]["checkpoint"]["digest"]


def test_two_process_preemption_agreement(trainer_runs):
    """Rank 1 alone is asked to stop: at the agreement after the first
    dispatch both stop, skip the eval and enter the forced save."""
    root, ranks = trainer_runs
    for r in ranks:
        p = r["preempt"]
        assert p == {**ranks[0]["preempt"]} and p["step"] == 1 and p["preempted"] and not p["evaluated"]
        assert p["saved"] == 0


@pytest.fixture(scope="module")
def gw_tree(tmp_path_factory):
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022ShallowSplit

    root = str(tmp_path_factory.mktemp("gw_tree"))
    t_syn.make_gwilliams_tree(root)
    build = _cli_cfg(root)
    build.rebuild_dataset = True
    Gwilliams2022ShallowSplit(build, wav2vec=t_syn.tiny_wav2vec(device="cpu"), device="cpu", **GW)
    return root


@pytest.mark.parametrize("device_resident", [False, True], ids=["host", "device_resident"])
def test_rank_blocks_of_the_global_draw_make_the_global_batch(gw_tree, device_resident):
    """The CLI's rule for every rank: the global batch's ids and session
    choices drawn alike from the shared rng, the rank's block of each
    materialized (sample_batch, or the device-resident batcher). The ranks'
    blocks concatenate to the one-process batch bit for bit, and the rng
    stands where the one process leaves it."""
    from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022ShallowSplit

    ds = Gwilliams2022ShallowSplit(_cli_cfg(gw_tree), device="cpu", **GW)
    dr = DeviceResidentGwilliams(ds, device="cpu") if device_resident else None

    def make(rng, ids, choices=None):
        return dr.gather(dr.make_index_batch(rng, ids, choices)) if dr else ds.sample_batch(rng, ids, choices)

    ids = np.arange(8) * 3 % len(ds)
    single_rng = np.random.default_rng(4)
    single = make(single_rng, ids)
    single_next = single_rng.integers(1 << 30)
    blocks = []
    for rank in range(2):
        rng = np.random.default_rng(4)
        choices = ds.draw_choices(rng, len(ids))
        blk = slice(4 * rank, 4 * rank + 4)
        blocks.append(make(rng, ids[blk], choices[blk]))
        assert rng.integers(1 << 30) == single_next
    for k in single:
        got = np.concatenate([np.asarray(b[k]) for b in blocks])
        np.testing.assert_array_equal(got, np.asarray(single[k]), err_msg=k)
    assert len(set(np.asarray(single["subject_idxs"]).tolist())) > 1  # the draw varies across the batch


def test_cli_two_process_end_to_end(gw_tree):
    from speech_decoding_tpu_torch import train as t_train

    ranks = spawn_ranks(_rank_cli, 2, args=(gw_tree, free_port()), torch_threads=1, timeout=300)
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["world"] == 2 for r in ranks)
    assert ranks[0]["seed"] == ranks[1]["seed"] == 11  # rank 0's, broadcast
    h0, h1 = ranks[0]["hist"], ranks[1]["hist"]
    assert len(h0) == 2 and [
        {k: v for k, v in h.items() if k != "train_segments_per_sec"} for h in h0] == [
        {k: v for k, v in h.items() if k != "train_segments_per_sec"} for h in h1]
    ckpts = os.path.join(gw_tree, "shared_ckpts")
    assert sorted(os.listdir(ckpts)) == ["epoch_0.pt", "epoch_1.pt"]
    # one process on the same seed draws the same global batches. The test
    # top-k is left out: from the initial BN running statistics this small
    # encoder maps the 10 test segments to near-identical embeddings
    # (tests/test_torch_cli.py's docstring), whose ranks turn on rounding
    # (seed 11 moves two of them); the test loss holds the eval at 1e-5
    cfg = _cli_cfg(gw_tree)
    cfg.set_path("resolved_seed", ranks[0]["seed"])
    cfg.set_path("checkpoint.dir", os.path.join(gw_tree, "one_process_ckpts"))
    for got, want in zip(h0, t_train.run(cfg, device="cpu")):
        _assert_history(got, want, test_topk=False)


# -- fail loudly (tests/test_multihost.py's cases, torchrun's variables) ---------------------------


class _Args:
    """An args stub exposing .select (the only Config API used)."""

    def __init__(self, multihost_flag):
        self._mh = multihost_flag

    def select(self, key, default=None):
        return self._mh if key == "tpu.multihost" else default


def _no_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def _env(monkeypatch, world):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")


def _fail(*a, **k):
    raise RuntimeError("the coordinator is unreachable")


def test_multihost_flag_without_coords_fails_loudly(monkeypatch):
    """tpu.multihost=true with no coordinates never runs single-process:
    the env:// init is attempted, and its failure raises."""
    _no_env(monkeypatch)

    def no_env(*a, **k):
        raise ValueError("environment variable MASTER_ADDR expected, but not set")

    monkeypatch.setattr(dist, "init_process_group", no_env)
    with pytest.raises(RuntimeError, match="found no coordinates"):
        maybe_init_distributed(_Args(True), device="cpu")


def test_multihost_flag_single_process_init_fails_loudly(monkeypatch):
    """An init that 'succeeds' into one process is still a
    misconfiguration when multi-process was asked for."""
    _no_env(monkeypatch)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="single-process"):
        maybe_init_distributed(_Args(True), device="cpu")


def test_multihost_default_off_is_noop(monkeypatch):
    _no_env(monkeypatch)
    monkeypatch.setattr(dist, "init_process_group", _fail)
    assert maybe_init_distributed(_Args(False)) is False


def test_multihost_flag_env_coords_init_failure_fails_loudly(monkeypatch):
    """The env-coordinates path: a swallowed init failure must not demote
    an explicit tpu.multihost=true run to one process."""
    _env(monkeypatch, 2)
    monkeypatch.setattr(dist, "init_process_group", _fail)
    with pytest.raises(RuntimeError, match="did not reach"):
        maybe_init_distributed(_Args(True), device="cpu")


def test_env_coords_without_flag_also_fails_loudly(monkeypatch):
    """torchrun's variables are an explicit multi-process launch on their
    own: an init failure raises even when tpu.multihost is unset."""
    _env(monkeypatch, 2)
    monkeypatch.setattr(dist, "init_process_group", _fail)
    with pytest.raises(RuntimeError, match="did not reach"):
        maybe_init_distributed(_Args(False), device="cpu")


def test_env_coords_world_size_one_is_legitimate(monkeypatch):
    """WORLD_SIZE=1 without the flag (a launcher templating the variables
    onto one process) is single-process, with no error."""
    _env(monkeypatch, 1)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    assert maybe_init_distributed(_Args(False), device="cpu") is False


def test_multihost_flag_tolerates_prior_launcher_init(monkeypatch):
    """A launcher that initialized the process group itself: no second
    init, and the run is multi-process."""
    monkeypatch.setattr(dist, "init_process_group", _fail)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    _no_env(monkeypatch)
    assert multihost.maybe_init_distributed(_Args(True)) is True
    _env(monkeypatch, 4)
    assert multihost.maybe_init_distributed(_Args(False)) is True


def test_multihost_flag_env_world_size_one_still_raises(monkeypatch):
    """Under tpu.multihost=true even the otherwise legitimate WORLD_SIZE=1
    launch raises when the run stays single-process."""
    _env(monkeypatch, 1)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="did not reach"):
        maybe_init_distributed(_Args(True), device="cpu")


# -- host-local batches and the global draws ----------------------------------------------------------


def test_host_local_slice_and_local_batch(monkeypatch):
    assert host_local_slice(8) == slice(0, 8)  # one process: the whole batch
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    assert host_local_slice(8) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        host_local_slice(6)
    from speech_decoding_tpu_torch.parallel import DataGroup

    g = DataGroup(world=4, rank=1, device=torch.device("cpu"))
    out = local_batch({"X": np.ones((2, 3), np.float32), "subject_idxs": np.array([1, 0])}, g)
    assert out["X"].shape == (2, 3) and out["subject_idxs"].dtype == torch.int32


def _tiny_brennan(num_subjects=8, num_segments=16, C_=4, L=10):
    """A Brennan2018Dataset with just the attributes sample_batch needs."""
    from speech_decoding_tpu_torch.data.brennan2018 import Brennan2018Dataset

    ds = Brennan2018Dataset.__new__(Brennan2018Dataset)
    rng = np.random.default_rng(7)
    ds.X = np.ascontiguousarray(rng.normal(size=(num_subjects, C_, num_segments * L)).astype(np.float32))
    ds.Y = np.ascontiguousarray(rng.normal(size=(3, num_segments * L)).astype(np.float32))
    ds.num_subjects, ds.num_segments = num_subjects, num_segments
    ds.seq_len_samp = ds.segment_len = L
    ds.baseline_len_samp = 2
    return ds


def test_multihost_sampling_decorrelated_and_matches_single_process():
    """Each rank draws the full global choice vector from the shared rng
    and keeps its block: blocks are iid, and the ranks' blocks concatenate
    to the one-process batch bit for bit."""
    ds = _tiny_brennan()
    n, world = 16, 2
    ids = np.arange(n)
    blocks = [slice(0, n // world), slice(n // world, n)]
    # each rank drawing its block internally repeats one subject pattern
    old = [ds.sample_batch(np.random.default_rng(3), ids[blk]) for blk in blocks]
    np.testing.assert_array_equal(old[0]["subject_idxs"], old[1]["subject_idxs"])
    ranks = []
    for blk in blocks:
        rng = np.random.default_rng(3)
        choices = ds.draw_choices(rng, n)
        ranks.append(ds.sample_batch(rng, ids[blk], choices[blk]))
    assert not np.array_equal(ranks[0]["subject_idxs"], ranks[1]["subject_idxs"])
    single = ds.sample_batch(np.random.default_rng(3), ids)
    for k in ("subject_idxs", "X", "Y"):
        np.testing.assert_array_equal(np.concatenate([r[k] for r in ranks]), single[k])


def test_multihost_rng_stream_position_matches_single_process():
    """After one global draw the ranks and one process stand at the same
    stream position: the next batch matches too."""
    ds = _tiny_brennan()
    n = 8
    ids1, ids2 = np.arange(n), np.arange(n, 2 * n) % ds.num_segments
    rng = np.random.default_rng(11)
    choices1 = ds.draw_choices(rng, n)
    ds.sample_batch(rng, ids1[:4], choices1[:4])
    choices2 = ds.draw_choices(rng, n)
    rng1 = np.random.default_rng(11)
    s1, s2 = ds.sample_batch(rng1, ids1), ds.sample_batch(rng1, ids2)
    np.testing.assert_array_equal(choices1, s1["subject_idxs"])
    np.testing.assert_array_equal(choices2, s2["subject_idxs"])


def test_gwilliams_draw_choices_matches_internal_draw():
    """Gwilliams' draw_choices repeats sample_batch's per-segment scalar
    draws exactly (values and stream position)."""
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022DatasetBase

    ds = Gwilliams2022DatasetBase.__new__(Gwilliams2022DatasetBase)
    ds.X = {f"s{i:02d}_sess0": {} for i in range(6)}
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    a = ds.draw_choices(r1, 32)
    b = np.asarray([r2.integers(len(ds.X)) for _ in range(32)])
    np.testing.assert_array_equal(a, b)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)
