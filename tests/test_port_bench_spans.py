"""The benchmark's readers of the program's spans (``port_bench/program_spans.py``
and the nine ``port_bench/metrics/*`` files that use it) on a hand-made
trace and span log: each reader's arithmetic, clipping at the window's
edges, the clock check against the trace's host events, and the cases in
which every reader leaves its metric out."""

import json
import os
import re
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from port_bench import cells, program_spans  # noqa: E402
from speech_decoding_tpu_torch.utils import profiling  # noqa: E402
from speech_decoding_tpu_torch.utils.profiling import Span, SpanLog  # noqa: E402

CELL = "gw208-train-b256-resident"
READERS = ["host_step_ms.train", "host_forward_ms.train", "host_backward_ms.train", "host_optimizer_ms.train",
           "idle_in_step_share.train", "idle_in_wait_share.train", "stack_ms.train", "data_ms.train"]
GRAPH_READER = "graph_step_share.train"  # the share of steps replayed from a CUDA graph

# µs; the window is 100 ms, the device busy 50 ms of it
T0, T1 = 1_000_000, 1_100_000
BUSY = [(1_000_000, 1_010_000), (1_030_000, 1_040_000), (1_060_000, 1_090_000)]
MAIN, PRODUCER = "MainThread", "sd-prefetch"
# (name, thread, start µs, end µs): three steps, the first opened before the
# window and the last closed after it, the loop's two waits between them
SPANS = [
    ("sd.step", MAIN, 990_000, 1_020_000), ("sd.step.forward", MAIN, 991_000, 995_000),
    ("sd.step.backward", MAIN, 995_000, 1_012_000), ("sd.step.optimizer", MAIN, 1_012_000, 1_015_000),
    ("sd.loop.wait", MAIN, 1_020_000, 1_025_000),
    ("sd.step", MAIN, 1_025_000, 1_055_000), ("sd.step.forward", MAIN, 1_026_000, 1_036_000),
    ("sd.step.backward", MAIN, 1_036_000, 1_050_000), ("sd.step.optimizer", MAIN, 1_050_000, 1_052_000),
    ("sd.loop.wait", MAIN, 1_055_000, 1_080_000),
    ("sd.step", MAIN, 1_080_000, 1_120_000), ("sd.step.forward", MAIN, 1_081_000, 1_091_000),
    ("sd.step.backward", MAIN, 1_091_000, 1_110_000), ("sd.step.optimizer", MAIN, 1_110_000, 1_112_000),
    ("sd.loop.stack", PRODUCER, 995_000, 1_001_000), ("sd.loop.stack", PRODUCER, 1_002_000, 1_005_000),
    ("sd.loop.stack", PRODUCER, 1_095_000, 1_105_000),
    ("sd.data.index", PRODUCER, 1_010_000, 1_011_000), ("sd.data.gather", PRODUCER, 1_011_000, 1_014_000),
    ("sd.data.index", PRODUCER, 1_060_000, 1_060_500), ("sd.data.gather", PRODUCER, 1_060_500, 1_062_500),
]
# by hand: steps 20 (clipped) + 30 + 20 (clipped) ms over the 2 that start
# in the window; forwards 0 + 10 + 10; backwards 12 (clipped) + 14 + 9
# (clipped); optimizers 3 + 2 + 0; idle inside the steps 10 + 20 + 10 ms and
# inside the waits 5 + 5 ms of the 100-ms window; stacks 1 (clipped) + 3 + 5
# (clipped) over 2 groups; data 1 + 3 + 0.5 + 2 over 2 batches
WANT = {"host_step_ms.train": 70 / 2, "host_forward_ms.train": 20 / 2, "host_backward_ms.train": 35 / 2,
        "host_optimizer_ms.train": 5 / 2, "idle_in_step_share.train": 40.0, "idle_in_wait_share.train": 10.0,
        "stack_ms.train": 9 / 2, "data_ms.train": 6.5 / 2}


class FakeTrace:
    """What the readers take from ``port_bench.trace.Trace``."""

    def __init__(self, t0, t1, busy, host_events, device=True):
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e6
        self.busy = busy
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.device_events = [("kernel", s, e) for s, e in busy] if device else []
        self._ops = sorted(host_events)


def _ctx(spans=SPANS, base_us=0, traced_shift_us=-200.0, device=True, dropped=0):
    """A context and a log of ``spans``, both moved by ``base_us``; the
    trace's host events hold each main-thread span ``traced_shift_us`` from
    its logged start, and some operations."""
    host = [(s + base_us + traced_shift_us, e + base_us + traced_shift_us, n) for n, th, s, e in spans if th == MAIN]
    host += [(s + base_us + 10, s + base_us + 20, "aten::mm") for n, th, s, e in spans if n == "sd.step.forward"]
    trace = FakeTrace(T0 + base_us, T1 + base_us, [(s + base_us, e + base_us) for s, e in BUSY], host, device)
    log = SpanLog(maxlen=len(spans) + 1)
    for n, th, s, e in spans:
        log.add(Span(n, th, (s + base_us) * 1000, (e + base_us) * 1000))
    log.dropped = dropped
    return SimpleNamespace(trace=trace, counts={"steps": 2, "segments": 512, "batch": 256},
                           window_s=trace.window_s, cfg={}, traffic={}), log


def _read(ctx, log, monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", log)
    return {n: cells.metric_reader(n)(ctx) for n in READERS}


def test_each_reader_by_hand(monkeypatch):
    ctx, log = _ctx()
    got = _read(ctx, log, monkeypatch)
    assert got == pytest.approx(WANT, rel=1e-12, abs=0)
    # the two idle shares lie within the device's: here they tile it
    idle = 100.0 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
    assert got["idle_in_step_share.train"] + got["idle_in_wait_share.train"] == pytest.approx(idle) == 50.0
    w = program_spans.window_spans(ctx)
    assert w.count("sd.step") == 2 and w.count("sd.loop.stack") == 2 and w.count("sd.data.gather") == 2


def test_on_the_epoch_clock(monkeypatch):
    """The same at the profiler's real magnitudes (Unix-epoch µs), where
    ns → µs rounds in the last place."""
    ctx, log = _ctx(base_us=1_792_326_600_912_815)
    got = _read(ctx, log, monkeypatch)
    assert got == pytest.approx(WANT, rel=0, abs=1e-3)


@pytest.mark.parametrize("traced_shift_us, read", [(-999.0, True), (999.0, True), (-1000.0, False), (1500.0, False)])
def test_the_clock_check(monkeypatch, traced_shift_us, read):
    """Every reader returns None where the log's sd.step starts lie 1 ms or
    more from the trace's."""
    ctx, log = _ctx(traced_shift_us=traced_shift_us)
    assert program_spans.clock_offset_us(ctx.trace, log.spans()) == pytest.approx(-traced_shift_us)
    got = _read(ctx, log, monkeypatch)
    if read:
        assert got == pytest.approx(WANT, rel=1e-12)
    else:
        assert got == dict.fromkeys(READERS)


def test_nothing_is_read_without_spans(monkeypatch):
    ctx, log = _ctx()
    # a program without the spans: no sd.step among the trace's host events
    ctx.trace._ops = [op for op in ctx.trace._ops if not op[2].startswith("sd.")]
    assert _read(ctx, log, monkeypatch) == dict.fromkeys(READERS)
    # an empty log, or a program that keeps none
    ctx, _ = _ctx()
    assert _read(ctx, SpanLog(), monkeypatch) == dict.fromkeys(READERS)
    monkeypatch.delattr(profiling, "span_log")
    assert {n: cells.metric_reader(n)(ctx) for n in READERS} == dict.fromkeys(READERS)
    # no trace
    assert {n: cells.metric_reader(n)(SimpleNamespace(trace=None)) for n in READERS} == dict.fromkeys(READERS)


def test_a_log_that_dropped_spans_of_the_window_is_not_read(monkeypatch):
    late = [s for s in SPANS if s[2] >= T0]
    ctx, log = _ctx(late, dropped=3)
    assert _read(ctx, log, monkeypatch) == dict.fromkeys(READERS)
    # spans dropped from before the window leave it whole
    ctx, log = _ctx(dropped=3)
    assert _read(ctx, log, monkeypatch) == pytest.approx(WANT, rel=1e-12)


def test_no_idle_share_without_device_operations(monkeypatch):
    ctx, log = _ctx(device=False)
    got = _read(ctx, log, monkeypatch)
    assert got["idle_in_step_share.train"] is None and got["idle_in_wait_share.train"] is None
    assert got["host_step_ms.train"] == pytest.approx(WANT["host_step_ms.train"], rel=1e-12)


@pytest.mark.parametrize("graphed, want", [((1_025_000, 1_080_000), 100.0), ((1_080_000,), 50.0), ((), 0.0)])
def test_the_graph_step_share(monkeypatch, graphed, want):
    """Of the two steps that start in the window, those holding an
    ``sd.step.graph`` (the step opened before the window holds one too, and
    is not counted)."""
    spans = SPANS + [("sd.step.graph", MAIN, 990_500, 1_000_500)]
    spans += [("sd.step.graph", MAIN, s + 500, s + 5_000) for s in graphed]
    ctx, log = _ctx(spans)
    monkeypatch.setattr(profiling, "_LOG", log)
    assert cells.metric_reader(GRAPH_READER)(ctx) == want
    # the other readers are unmoved by the graph's spans
    assert _read(ctx, log, monkeypatch) == pytest.approx(WANT, rel=1e-12)


def test_no_graph_step_share_where_nothing_can_replay(monkeypatch):
    """None without device operations, without a trace or a span log, and
    from a program that declares no ``sd.step.graph`` (the parent of the
    graphed step)."""
    spans = SPANS + [("sd.step.graph", MAIN, 1_025_500, 1_030_000)]
    read = cells.metric_reader(GRAPH_READER)
    ctx, log = _ctx(spans)
    monkeypatch.setattr(profiling, "_LOG", log)
    assert read(ctx) == 50.0
    assert read(SimpleNamespace(trace=None)) is None
    assert read(_ctx(spans, device=False)[0]) is None
    monkeypatch.setattr(profiling, "_LOG", SpanLog())
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "_LOG", log)
    monkeypatch.setattr(profiling, "SPANS", tuple(n for n in profiling.SPANS if n != "sd.step.graph"))
    assert read(ctx) is None


def test_the_readers_read_the_programs_spans():
    """Each span the program opens is read by a metric, and every metric of
    the spans is declared for the training cell."""
    read = set()
    for n in READERS + [GRAPH_READER]:
        with open(os.path.join(cells.ROOT, "port_bench", "metrics", f"{n}.py")) as f:
            read |= set(re.findall(r'"(sd\.[a-z.]+)"', f.read()))
    assert read == set(profiling.SPANS) and program_spans.STEP == profiling.STEP
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for n in READERS + [GRAPH_READER]:
        m = per_layer[n]
        assert (m["source"], m["moves"], m["workloads"]) == ("program_span", "train_segments_per_s", [CELL]), n
    assert (per_layer[GRAPH_READER]["unit"], per_layer[GRAPH_READER]["layer"]) == ("%", "train step")
    names = [m["name"] for m in cells.Cell(CELL).per_layer]
    i = names.index(READERS[0])
    assert names[i : i + 9] == READERS + [GRAPH_READER]
