"""CPU tests of the device readings: a ``Trace`` built from synthetic
profiler events finds lost device records and then reads no device-side
metric, and names a gap under a garbage collection; the driver's peak is
the allocator's reserved peak; ``host_replay_ms.train`` by hand. Run with ``python -m pytest port_bench -q``."""

from __future__ import annotations

import json
import shutil
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from port_bench import cells, program_spans  # noqa: E402
from port_bench.run import Context, run_cell  # noqa: E402
from port_bench.trace import Trace, gc_pauses, lost_records  # noqa: E402

CELL = "gw208-train-b256-resident"
ROOT = cells.ROOT
DEVICE_SIDE = ["device_idle_share.train", "idle_in_step_share.train", "idle_in_wait_share.train",
               "K2_roofline.train"]
KERNELS = ("tap_conv_dw_bf16_kernel", "elementwise_kernel", "nvjet_gemm")


class _Event:
    def __init__(self, name, on_device, start_us, dur_us, corr=0, note=False):
        self._v = (name, on_device, start_us, dur_us, corr, note)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int(self._v[3] * 1000)

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def _profile(steps=4, drop=None, bare=None):
    """A window of ``steps`` replayed steps: each a host ``sd.step`` with a
    ``cudaGraphLaunch`` inside and three device records of 300 µs on its
    correlation id, its device annotation beside them. ``drop``: the step
    that loses one device record; ``bare``: the step that loses all three."""
    ev = [_Event("bench.window", False, 0, 1000 * (steps + 1) + 500)]
    for k in range(1, steps + 1):
        a = 1000 * k
        ev += [_Event("sd.step", False, a, 500, note=True), _Event("cudaGraphLaunch", False, a + 100, 20, 100 + k),
               _Event("sd.step", True, a + 200, 900, note=True)]
        for j, name in enumerate(KERNELS):
            if k == bare or (k == drop and j == 1):
                continue
            ev.append(_Event(name, True, a + 200 + 300 * j, 300, 100 + k))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: ev)))


def _ctx(trace, steps=4):
    cfg = cells.Cell(CELL).config
    return Context(cfg, {}, {"counts": {"steps": steps, "segments": 256 * steps, "batch": 256},
                             "window_s": trace.window_s, "trace": trace})


class _Log:
    def __init__(self, spans):
        self._spans, self.dropped = spans, 0

    def spans(self):
        return list(self._spans)


def _spans_from(trace, extra=()):
    """The program's span log as the port keeps it: the trace's sd.step host
    events (same clock), and ``extra`` (name, start µs, end µs)."""
    from speech_decoding_tpu_torch.utils.profiling import Span

    out = [Span("sd.step", "MainThread", int(s * 1e3), int(e * 1e3)) for s, e, n in trace._ops if n == "sd.step"]
    return out + [Span(n, "MainThread", int(a * 1e3), int(b * 1e3)) for n, a, b in extra]


@pytest.mark.parametrize("drop, bare, whole", [(None, None, True), (3, None, False), (None, 2, False)])
def test_a_trace_that_lost_records_reads_no_device_metric(monkeypatch, drop, bare, whole):
    tr = Trace(_profile(drop=drop, bare=bare), step="sd.step")
    assert tr.whole is whole and bool(tr.lost) is not whole, tr.lost
    if whole:
        assert tr.busy_s == pytest.approx(4 * 900e-6)
        assert not any(name == "sd.step" for name, _, _ in tr.device_events)
    wait = [("sd.loop.wait", 1000 * k + 600, 1000 * k + 800) for k in range(1, 5)]
    monkeypatch.setattr(program_spans, "_log", lambda: _Log(_spans_from(tr, wait)))
    ctx = _ctx(tr)
    got = {m: cells.metric_reader(m)(ctx) for m in DEVICE_SIDE}
    if whole:
        assert all(v is not None for v in got.values()), got
        assert got["device_idle_share.train"] == pytest.approx(100 * (1 - 3600e-6 / 5500e-6))
        # a step's host span [a, a+500] is idle until its records start at a+200, less the
        # 100 µs that the step before's records still run: 200 + 3 x 100 µs
        assert got["idle_in_step_share.train"] == pytest.approx(100 * 500e-6 / 5500e-6)
        assert got["idle_in_wait_share.train"] == pytest.approx(0.0)
    else:
        assert all(v is None for v in got.values()), got


def test_lost_records_by_hand():
    records = {1: 5, 2: 5, 3: 4, 4: 6}
    calls = [(10.0, 1, "cudaGraphLaunch"), (20.0, 2, "cudaGraphLaunch"), (30.0, 3, "cudaGraphLaunch"),
             (31.0, 9, "cudaLaunchKernel"), (40.0, 4, "cudaGraphLaunch")]
    steps = [(5.0, 15.0), (15.0, 25.0), (25.0, 35.0), (35.0, 45.0)]
    found = lost_records(records, calls, steps)
    assert found == ["1 of 5 launches have no device record", "1 of 4 steps hold fewer device records than most "
                     "(4 against 5)"]
    # another thread's launches inside a step only add records: no loss
    assert lost_records({1: 5, 2: 5, 3: 5, 9: 1}, calls[:4], steps[:3]) == []


def test_a_run_whose_trace_lost_records_leaves_out_its_breakdown(tmp_path):
    """The whole run: a driver whose trace lost a record reports no
    device-side metric and no breakdown, and says what was lost."""
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(f"{ROOT}/port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "port_bench" / "drivers" / "synthetic_trace.py").write_text(
        "from port_bench.test_port_bench_trace import _profile\n"
        "from port_bench.trace import Trace\n\n\n"
        "def run(cfg, traffic, seed, seconds, trace, device, t_start, faults=(), root=None):\n"
        "    tr = Trace(_profile(drop=traffic['drop']), step='sd.step')\n"
        "    return {'e2e': {}, 'counts': {'steps': 4, 'segments': 1024, 'batch': 256}, 'window_s': tr.window_s,\n"
        "            'trace': tr, 'readings': {}, 'attempted': 4, 'failed': 0, 'memory_peak_bytes': 0}\n")
    for drop in (None, 2):
        result, _ = run_cell(CELL, 1, 1.0, True, "cpu", root=str(tmp_path), t_start=time.perf_counter(),
                             traffic_override={"driver": "synthetic_trace", "drop": drop})
        json.dumps(result)
        assert set(result.get("breakdown", ())) == ({"device_ops", "idle_gaps"} if drop is None else set())
        assert bool(result["trace_lost"]) is (drop is not None)
        assert ("K2_roofline.train" in result["metrics"]) is (drop is None)
        assert result["device"]["busy_s"] > 0 and list(result)[-1] == "checks"


def test_a_gap_under_a_garbage_collection_is_named_so():
    """A collection that stops the host names the idle gap that begins
    inside it; gc_pauses records the collections of its block only."""
    import gc

    with gc_pauses(True) as pauses:
        gc.collect()
    gc.collect()
    assert len(pauses) == 1 and pauses[0][1] >= pauses[0][0]
    # step 1's records end at 2100 µs, step 2's begin at 2200: a pause over it
    tr = Trace(_profile(), step="sd.step", pauses=[(2050.0, 2300.0)])
    gaps = dict(tr.idle_gaps(10))
    assert gaps["bench.gc|cudaGraphLaunch|+0.002s"] == pytest.approx(100e-6)
    assert sum(name.startswith("bench.gc") for name in gaps) == 1


def test_the_driver_reads_the_reserved_peak(monkeypatch):
    """A CUDA graph's replay allocates nothing: the peak is the allocator's
    reserved bytes, which hold its pool, not the allocated bytes."""
    train = cells.load("drivers", "train")
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda device=None: 61 * 2**30)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 51 * 2**30)
    assert train.memory_peak(torch.device("cuda")) == 61 * 2**30


def test_host_replay_ms_by_hand(monkeypatch):
    tr = Trace(_profile(steps=3), step="sd.step")
    # a replay of 40, 50 and 60 µs inside the three steps: 50 µs = 0.05 ms a step
    replays = [("sd.step.graph", 1000 * k + 50, 1000 * k + 50 + 30 + 10 * k) for k in (1, 2, 3)]
    read = cells.metric_reader("host_replay_ms.train")
    monkeypatch.setattr(program_spans, "_log", lambda: _Log(_spans_from(tr, replays)))
    assert read(_ctx(tr, 3)) == pytest.approx(0.05)
    # eager steps open no sd.step.graph: nothing to read
    monkeypatch.setattr(program_spans, "_log", lambda: _Log(_spans_from(tr)))
    assert read(_ctx(tr, 3)) is None
