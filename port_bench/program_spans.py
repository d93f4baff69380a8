"""The program's spans in the traced window, for the per-layer metrics that
read them.

The port opens its spans with ``utils.profiling.annotate``, which, while a
profiler records, also logs each span with its thread and its start and
end on ``time.time_ns()`` (``profiling.span_log()``): the profiler records
only the thread that started it, and the Prefetcher's producer thread
starts inside the window. The profiler stamps its events on that clock in
nanoseconds; ``trace.Trace`` keeps them in microseconds.

Spans are clipped to the window ``[trace.t0, trace.t1]``; a span counts in
a step, group or batch if its start lies in the window. Main-thread spans
are both in the log and among the trace's host events, so the log's clock
is checked against the trace's on the ``sd.step`` spans: where their median
start difference is 1 ms or more, or where the program logs no spans (a
program without them), nothing is read and every metric here is left out.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from port_bench.trace import _union

STEP = "sd.step"
CLOCK_LIMIT_US = 1000.0

Interval = Tuple[float, float]


def _log():
    """The program's span log, or None where the program keeps none."""
    from speech_decoding_tpu_torch.utils import profiling

    span_log = getattr(profiling, "span_log", None)
    return None if span_log is None else span_log()


def clock_offset_us(trace, spans) -> Optional[float]:
    """The median of (log start − trace start) in microseconds over the
    trace's ``sd.step`` host events, each against the log's ``sd.step``
    span nearest it; None where either has none."""
    logged = sorted(s.start_ns / 1e3 for s in spans if s.name == STEP)
    traced = [s for s, _, name in getattr(trace, "_ops", ()) if name == STEP]
    if not logged or not traced:
        return None
    diffs = []
    for t in traced:
        i = bisect.bisect_left(logged, t)
        near = [logged[j] for j in (i - 1, i) if 0 <= j < len(logged)]
        diffs.append(min((x - t for x in near), key=abs))
    return statistics.median(diffs)


class WindowSpans:
    """The spans of a log clipped to a trace's window: by name, the clipped
    intervals (µs) and the number that start in the window."""

    def __init__(self, trace, spans):
        self.trace = trace
        self.window_s = trace.window_s
        self._clipped: Dict[str, List[Interval]] = {}
        self._count: Dict[str, int] = {}
        for s in spans:
            a, b = s.start_ns / 1e3, s.end_ns / 1e3
            lo, hi = max(a, trace.t0), min(b, trace.t1)
            if hi > lo:
                self._clipped.setdefault(s.name, []).append((lo, hi))
            if trace.t0 <= a <= trace.t1:
                self._count[s.name] = self._count.get(s.name, 0) + 1

    def count(self, name: str) -> int:
        return self._count.get(name, 0)

    def seconds(self, name: str) -> float:
        return sum(b - a for a, b in self._clipped.get(name, ())) / 1e6

    def idle_seconds(self, name: str) -> float:
        """Seconds inside ``name``'s spans in which the device ran nothing
        (the window less the union of device operations)."""
        busy = self.trace.busy
        starts = [a for a, _ in busy]
        return sum(_uncovered(iv, busy, starts) for iv in _union(self._clipped.get(name, []))) / 1e6


def _uncovered(iv: Interval, busy: Sequence[Interval], starts: Sequence[float]) -> float:
    """Length of ``iv`` outside the sorted, disjoint intervals ``busy``
    (``starts`` their starts)."""
    a, b = iv
    covered = 0.0
    for i in range(max(0, bisect.bisect_right(starts, a) - 1), len(busy)):
        s, e = busy[i]
        if s >= b:
            break
        covered += max(0.0, min(e, b) - max(s, a))
    return (b - a) - covered


def window_spans(ctx) -> Optional[WindowSpans]:
    """The program's spans in ``ctx``'s traced window, or None: no trace, no
    span log, spans dropped from the log inside the window, or the clock
    check failed."""
    if ctx.trace is None:
        return None
    log = _log()
    if log is None:
        return None
    spans = log.spans()
    if not spans:
        return None
    if log.dropped and min(s.start_ns for s in spans) / 1e3 > ctx.trace.t0:
        return None
    offset = clock_offset_us(ctx.trace, spans)
    if offset is None or abs(offset) >= CLOCK_LIMIT_US:
        return None
    return WindowSpans(ctx.trace, spans)


def ms_per(ctx, names: Sequence[str], per: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` in the window per span ``per``
    that starts in it."""
    w = window_spans(ctx)
    if w is None or not w.count(per):
        return None
    return 1e3 * sum(w.seconds(n) for n in names) / w.count(per)


def idle_share(ctx, name: str) -> Optional[float]:
    """The share (%) of the window in which the device was idle inside the
    spans ``name``; None without device operations in the trace."""
    w = window_spans(ctx)
    if w is None or not w.count(name) or not ctx.trace.device_events:
        return None
    return 100.0 * w.idle_seconds(name) / w.window_s
