"""The train step replayed from a CUDA graph against the eager step, on the
card (``training/steps.py``). Marked ``cuda``; each test skips without a
CUDA device (the CPU tier holds the graph rule: ``test_torch_step_graph.py``).
Run on a GPU with

    python -m pytest tests/test_torch_step_graph_cuda.py -m cuda -q --noconftest

From one state and on the same batches, ten module-path steps with
different ids and drop masks each step, one closure (eager first call,
capture on the second, replays after) against a fresh closure a step (every
call its signature's first, so eager), with a batch of another size run
eagerly between them: parameters, BatchNorm statistics, Adam's moments and
each step's metrics agree, for the ``gemm`` and ``pallas_taps`` convs in f32
and bf16; the kernels' launch counters see the eager steps and the capture,
no replay. Two signatures in turns, each with its graph in the one shared
pool, against eager steps; a replay runs the eager step's hand-written
kernels (CUDA kernel records). Then K1 under capture, and the Trainer's
scan groups (the Prefetcher's thread gathering meanwhile) against the same
epoch with ids on the card, which no graph takes.
"""

import re
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, dropout_mask_at  # noqa: E402
from speech_decoding_tpu_torch.ops import subject_conv as sc  # noqa: E402
from speech_decoding_tpu_torch.ops import tap_conv as tc  # noqa: E402
from speech_decoding_tpu_torch.ops.scaling import window_scale_stats  # noqa: E402
from speech_decoding_tpu_torch.training import Trainer, create_train_state, make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

S, D1, D2, F, K, B, T = 4, 32, 48, 64, 4, 16, 40
B_OTHER = 12  # the batch of another size, run eagerly between the replays
LOC = ch_locations_2d("Gwilliams2022", cache=False)
C = len(LOC)
COLLATE = {"baseline_len_samp": 10, "clamp_lim": 20.0, "clamp": True, "precomputed": True, "channels_last": True}
STEPS, OTHER_AT = 10, 4  # the other-size batch runs after the 4th step
# a replay runs the eager step's kernels on the same inputs; cuBLAS may pick
# another algorithm under capture, which rounds differently
RTOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the kernel wrappers' counters (function, attribute): each counts its
# wrapper's launches from the host, so a capture once and a replay never
COUNTERS = ((sc.subject_matmul, "launches"), (sc.packed_weights, "packs"), (tc.tap_conv_dw, "launches"),
            (tc.tap_conv, "launches"))
# the CUDA kernels of those wrappers, by the names the profiler records
HAND_WRITTEN = re.compile(r"subject_matmul_\w*kernel|tap_conv\w*kernel|conv3_kernel|reduce_splits|reduce_parts")


def _reset():
    for fn, attr in COUNTERS:
        setattr(fn, attr, 0)


def _launches():
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in COUNTERS}


def _batch(dev, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(b, T, C, device=dev, generator=g) * 10 + 3
    return {"X": X, "Y": torch.randn(b, T, F, device=dev, generator=g),
            "subject_idxs": torch.from_numpy(np.random.default_rng(seed).integers(0, S, b).astype(np.int32)),
            "scale_stats": window_scale_stats(X.transpose(1, 2))}


def _sequence(dev):
    """(batch, mask) a step: ids and masks differ every step, and one batch of
    another size after the OTHER_AT-th."""
    seq = [(_batch(dev, B, i), dropout_mask_at(LOC, 19 * i, 0.2)) for i in range(STEPS)]
    seq.insert(OTHER_AT, (_batch(dev, B_OTHER, 100), dropout_mask_at(LOC, 7, 0.2)))
    ids = [b["subject_idxs"] for b, _ in seq if b["X"].shape[0] == B]
    masks = [m for b, m in seq if b["X"].shape[0] == B]
    assert all(not torch.equal(a, b) for a, b in zip(ids, ids[1:]))
    assert all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))
    return seq


def _state(dev, impl, dtype):
    enc = BrainEncoder(num_subjects=S, loc=LOC, D1=D1, D2=D2, F=F, K=K, compute_dtype=dtype, channels_last_io=True,
                       conv_impl=impl, generator=torch.Generator().manual_seed(0))
    return create_train_state(enc, lr=1e-3, device=dev)


def _run(dev, impl, dtype, graphed, seq=None):
    state = _state(dev, impl, dtype)
    step = make_train_step(collate=COLLATE)
    _reset()
    metrics = []
    for batch, mask in seq or _sequence(dev):
        run = step if graphed else make_train_step(collate=COLLATE)
        state, m = run(state, batch, drop_mask=mask)
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, _launches(), step


def _tensors(state, metrics):
    out = {f"param.{n}": p for n, p in state.encoder.named_parameters()}
    out["param.temp"] = state.clip.temp
    out.update({f"buffer.{n}": b for n, b in state.encoder.named_buffers()})
    adam = state.optimizer
    for n, p in [*state.encoder.named_parameters(), ("temp", state.clip.temp)]:
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"adam.{k}.{n}"] = adam.state[p][k]
    for i, m in enumerate(metrics):
        out.update({f"step{i}.{k}": v for k, v in m.items()})
    return out


def _worst(got, want):
    """(tensors not bitwise equal, worst relative difference)."""
    differ, worst = [], 0.0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if not torch.equal(g, w):
            differ.append(name)
            rel = float(((g.double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-30)))
            worst = max(worst, rel)
    return differ, worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("impl", ["gemm", "pallas_taps"])
def test_replayed_steps_match_eager_steps(dev, impl, dtype):
    g_state, g_metrics, g_launches, step = _run(dev, impl, dtype, graphed=True)
    e_state, e_metrics, e_launches, _ = _run(dev, impl, dtype, graphed=False)
    assert (step.captures, step.replays) == (1, STEPS - 1)
    assert e_launches["subject_matmul.launches"] == 2 * (STEPS + 1)
    assert e_launches["tap_conv_dw.launches"] == 15 * (STEPS + 1)
    assert e_launches["tap_conv.launches"] == (30 * (STEPS + 1) if impl == "pallas_taps" else 0)
    # the graphed run launches from the host only in its first step, the
    # capture and the other-size step: three of the eager run's eleven
    assert g_launches == {k: v * 3 // (STEPS + 1) for k, v in e_launches.items()}
    differ, worst = _worst(_tensors(g_state, g_metrics), _tensors(e_state, e_metrics))
    print(f"{impl} {dtype}: {len(differ)} tensors not bitwise equal, worst relative difference {worst:.3g}: "
          f"{differ[:8]}")
    assert worst <= RTOL, differ
    # each step's metrics are tensors of their own, and the steps differ
    for k in ("loss", "top1", "top10", "temp"):
        assert len({m[k].data_ptr() for m in g_metrics}) == len(g_metrics), k
    losses = [float(m["loss"]) for m in g_metrics]
    assert len(set(losses)) == len(losses) and all(np.isfinite(losses))


def test_two_signatures_in_turns_share_one_pool(dev):
    """Steps of two batch sizes in turns: each size captures its graph on its
    second call, both in one memory pool, and the replays in turns match
    eager steps (one graph's replay overwrites only the other's dead
    memory)."""
    seq = [(_batch(dev, B if i % 2 == 0 else B_OTHER, 200 + i), dropout_mask_at(LOC, 11 * i, 0.2))
           for i in range(STEPS)]
    g_state, g_metrics, _, step = _run(dev, "gemm", torch.bfloat16, graphed=True, seq=seq)
    e_state, e_metrics, _, _ = _run(dev, "gemm", torch.bfloat16, graphed=False, seq=seq)
    assert (step.captures, step.replays) == (2, STEPS - 2)
    differ, worst = _worst(_tensors(g_state, g_metrics), _tensors(e_state, e_metrics))
    print(f"two signatures: {len(differ)} tensors not bitwise equal, worst relative difference {worst:.3g}")
    assert worst <= RTOL, differ


def _kernels(fn):
    """The hand-written kernels' CUDA records while ``fn`` runs, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA and HAND_WRITTEN.search(e.name))


@pytest.mark.parametrize("impl", ["gemm", "pallas_taps"])
def test_a_replay_runs_the_eager_steps_kernels(dev, impl):
    """The CUDA kernel records of one replayed step equal an eager step's on
    the same state and batch, while the launch counters see none of the
    replay's."""
    state = _state(dev, impl, torch.bfloat16)
    step = make_train_step(collate=COLLATE)
    batch, mask = _batch(dev, B, 0), dropout_mask_at(LOC, 0, 0.2)
    for _ in range(3):  # eager, capture, replay
        state, _ = step(state, batch, drop_mask=mask)
    _reset()
    replayed = _kernels(lambda: step(state, batch, drop_mask=mask))
    assert step.replays == 3 and set(_launches().values()) == {0}
    eager = _kernels(lambda: make_train_step(collate=COLLATE)(state, batch, drop_mask=mask))
    assert eager[next(n for n in eager if "tap_conv_dw" in n)] == 15
    assert replayed == eager and _launches()["subject_matmul.launches"] == 2


def test_k1_under_capture_takes_card_ids_and_leaves_the_pack_cache(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(B, T, D1, device=dev, generator=g).bfloat16()
    w = (torch.randn(S, D1, D1, device=dev, generator=g) / D1 ** 0.5).bfloat16()
    ids = torch.zeros(B, dtype=torch.int32, device=dev)
    sc.subject_matmul(x, w, ids)  # eager: builds the library, caches w's image
    cached = {k: id(v) for k, v in sc._packs.items()}
    host_ids = ids.cpu()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(ValueError, match="on the card"):
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            sc.subject_matmul(x, w, host_ids)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = sc.subject_matmul(x, w, ids)
    assert sc.subject_matmul.route == "wgmma" and {k: id(v) for k, v in sc._packs.items()} == cached
    for seed in range(3):
        ids.copy_(torch.randint(0, S, (B,), device=dev, generator=torch.Generator(device=dev).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, sc.subject_matmul(x, w, ids)), seed


def _trainer(dev, ids_on_card):
    cfg = load_config(None, ["tpu.compute_dtype=bfloat16", "tpu.channels_last_io=true", "tpu.scan_steps=4",
                             f"D1={D1}", f"D2={D2}", f"K={K}", f"F={F}", "preprocs.last4layers=false", "lr=1e-3"])
    enc = BrainEncoder.from_config(cfg, LOC, S, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(enc, cfg, collate=COLLATE, device=dev)
    batches = [_batch(dev, B, i) for i in range(9)]  # two groups of 4 and a lone step
    if ids_on_card:
        batches = [{**b, "subject_idxs": b["subject_idxs"].to(dev)} for b in batches]
    out = trainer.run_epoch(0, batches, None)
    torch.cuda.synchronize()
    return trainer, out


def test_the_trainer_scan_replays_its_graph(dev):
    graphed, g_out = _trainer(dev, ids_on_card=False)
    eager, e_out = _trainer(dev, ids_on_card=True)
    assert (graphed.train_step.captures, graphed.train_step.replays) == (1, 8)
    assert (eager.train_step.captures, eager.train_step.replays) == (0, 0)
    want = {n: p for n, p in eager.state.encoder.state_dict().items()}
    differ, worst = _worst(graphed.state.encoder.state_dict(), want)
    print(f"trainer: {len(differ)} tensors not bitwise equal, worst relative difference {worst:.3g}")
    assert worst <= RTOL, differ
    assert g_out["train_loss"] == pytest.approx(e_out["train_loss"], rel=RTOL)
