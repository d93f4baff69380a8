"""The traced window: ``torch.profiler`` over the whole window, reduced to
the device's busy time, the device operations that took the most time, the
longest idle gaps named by what the host was doing, and device time by
kernel name.

Benchmark-side spans are ``record_function`` names that start with
``bench.``: the harness opens them around its own calls into each layer
(a batch fetch, an epoch).
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "bench."


def span(name: str):
    """A benchmark-side span (a no-op unless a profiler is recording)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def maybe_profile(enabled: bool, device_type: str):
    """Yields the profiler (or None): CPU and, on the card, CUDA activity."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """A reduced profile. Times are seconds; the window is [t0, t1] in the
    profiler's microseconds."""

    def __init__(self, prof):
        # the profiler's raw events: building its tree of FunctionEvents
        # takes minutes for a window of a million operations
        cuda = torch.autograd.DeviceType.CUDA
        events = []
        for e in prof.profiler.kineto_results.events():
            s_us = e.start_ns() / 1e3
            note = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
            events.append((e.name(), e.device_type() == cuda, s_us, s_us + e.duration_ns() / 1e3, note))
        win = [e for e in events if e[0] == SPAN_PREFIX + "window" and not e[1]]
        if not win:
            raise RuntimeError("the traced run has no bench.window span")
        t0_us, t1_us = win[0][2], win[0][3]
        self.window_s = (t1_us - t0_us) / 1e6
        # a record_function range is drawn on the device's timeline too: it
        # is no device operation
        annotations = {name for name, _, _, _, note in events if note or name.startswith(SPAN_PREFIX) or "#" in name}
        dev = []
        cpu = []
        for name, on_device, s_us, e_us, note in events:
            if on_device:
                if note or name in annotations:
                    continue
                s, t = max(s_us, t0_us), min(e_us, t1_us)
                if t > s:
                    dev.append((name, s, t))
            else:
                cpu.append((s_us, e_us, name))
        self.device_events = dev
        self.busy = _union([(s, t) for _, s, t in dev])
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6
        # host intervals: benchmark spans and innermost operations, for naming gaps
        self._spans = sorted(e for e in cpu if e[2].startswith(SPAN_PREFIX) and e[2] != SPAN_PREFIX + "window")
        self._ops = sorted(e for e in cpu if not e[2].startswith(SPAN_PREFIX))
        self.t0, self.t1 = t0_us, t1_us

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(t - s for name, s, t in self.device_events if match(name)) / 1e6

    def top_device_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, t in self.device_events:
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    @staticmethod
    def _innermost(intervals: Sequence[Tuple[float, float, str]], t: float) -> Optional[str]:
        starts = [s for s, _, _ in intervals]
        i = bisect.bisect_right(starts, t)
        best = None
        # the latest-starting interval that is still open at t
        for s, e, name in reversed(intervals[max(0, i - 4000) : i]):
            if e > t:
                best = name
                break
        return best

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest stretches of the window with no device activity,
        each named '<innermost benchmark span>|<innermost host operation>'
        open when it began."""
        gaps = []
        prev = self.t0
        for s, e in self.busy + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((s - prev, prev))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, start in gaps[:n]:
            sp = self._innermost(self._spans, start) or "no benchmark span"
            op = self._innermost(self._ops, start) or "no host operation"
            out.append([f"{sp}|{op}", length / 1e6])
        return out
