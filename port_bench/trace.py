"""The traced window: ``torch.profiler`` over the whole window, reduced to
the device's busy time, the device operations that took the most time, the
longest idle gaps named by what the host was doing, and device time by
kernel name.

Benchmark-side spans are ``record_function`` names that start with
``bench.``: the harness opens them around its own calls into each layer
(a batch fetch, an epoch), and ``bench.gc`` names the interpreter's garbage
collections in the window (``gc_pauses``): a full one stops the host long
enough for the card to run out of launched work.

A trace can lose device records (a profiler's buffers, a reduction that
drops some). ``Trace.lost`` says where it did, by two checks that hold
whatever the cause: every kernel or graph launch of the window has its
device records, and no step of the window (the host span the driver names,
recorded by the profiler itself) holds fewer device records than most
steps do: a step launches the same kernels each time, and the records it
holds are those of the launches inside it, matched by correlation id.
Where either fails, ``Trace.whole`` is false and the trace keeps no device
events, so that no device-side reading is taken from it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import gc
import re
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "bench."
# CUDA runtime and driver calls as the profiler names them (cudaLaunchKernel, cuLaunchKernelEx, ...)
_API = re.compile(r"cu(da)?[A-Z]")
_LAUNCH = ("LaunchKernel", "GraphLaunch")


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


@contextlib.contextmanager
def gc_pauses(enabled: bool):
    """Yields a list that receives the interpreter's garbage collections
    inside the block, as (start, end) in microseconds on the profiler's
    clock (``time.time_ns``, as the program's span log)."""
    out: List[Tuple[float, float]] = []
    if not enabled:
        yield out
        return
    began: List[int] = []

    def note(phase, info):
        if phase == "start":
            began.append(time.time_ns())
        elif began:
            out.append((began.pop() / 1e3, time.time_ns() / 1e3))

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def lost_records(records: Mapping[int, int], calls: Sequence[Tuple[float, int, str]],
                 steps: Sequence[Tuple[float, float]]) -> List[str]:
    """How a window's device records are found incomplete; empty where they
    are not. ``records``: device records by correlation id; ``calls``: the
    window's CUDA API calls (start, correlation id, name), sorted by start;
    ``steps``: the window's steps (host start, end)."""
    found = []
    launches = [c for _, c, name in calls if any(k in name for k in _LAUNCH)]
    bare = sum(1 for c in launches if not records.get(c))
    if bare:
        found.append(f"{bare} of {len(launches)} launches have no device record")
    starts = [s for s, _, _ in calls]
    held = []
    for a, b in steps:
        i, j = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        held.append(sum(records.get(c, 0) for _, c, _ in calls[i:j]))
    if held:
        most = collections.Counter(held).most_common(1)[0][0]
        short = [n for n in held if n < most]
        if short:
            found.append(f"{len(short)} of {len(held)} steps hold fewer device records than most "
                         f"({min(short)} against {most})")
    return found


class Trace:
    """A reduced profile. Times are seconds; the window is [t0, t1] in the
    profiler's microseconds. ``step``: the name of the host span that one
    step of the driver's loop opens, for the completeness check; ``pauses``:
    the window's garbage collections (``gc_pauses``), for naming gaps."""

    def __init__(self, prof, step: Optional[str] = None, pauses: Sequence[Tuple[float, float]] = ()):
        # the profiler's raw events: building its tree of FunctionEvents
        # takes minutes for a window of a million operations
        cuda = torch.autograd.DeviceType.CUDA
        events = []
        for e in prof.profiler.kineto_results.events():
            s_us = e.start_ns() / 1e3
            note = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
            events.append((e.name(), e.device_type() == cuda, s_us, s_us + e.duration_ns() / 1e3, note,
                           e.correlation_id()))
        win = [e for e in events if e[0] == SPAN_PREFIX + "window" and not e[1]]
        if not win:
            raise RuntimeError("the traced run has no bench.window span")
        t0_us, t1_us = win[0][2], win[0][3]
        self.window_s = (t1_us - t0_us) / 1e6
        # a record_function range is drawn on the device's timeline too: it
        # is no device operation. Kernels are not told apart by the letters of
        # their names: demangled ones hold '#' ({lambda()#1}) and '.'
        annotations = {name for name, _, _, _, note, _ in events if note or name.startswith(SPAN_PREFIX)}
        dev = []
        cpu = []
        records: Dict[int, int] = collections.Counter()
        for name, on_device, s_us, e_us, note, corr in events:
            if on_device:
                if note or name in annotations:
                    continue
                records[corr] += 1
                s, t = max(s_us, t0_us), min(e_us, t1_us)
                if t > s:
                    dev.append((name, s, t))
            else:
                cpu.append((s_us, e_us, name, corr))
        busy = _union([(s, t) for _, s, t in dev])
        self.busy_s = sum(t - s for s, t in busy) / 1e6
        # host intervals: benchmark spans and innermost operations, for naming gaps
        self._spans = sorted([e[:3] for e in cpu if e[2].startswith(SPAN_PREFIX) and e[2] != SPAN_PREFIX + "window"]
                             + [(s, e, SPAN_PREFIX + "gc") for s, e in pauses])
        self._ops = sorted(e[:3] for e in cpu if not e[2].startswith(SPAN_PREFIX))
        self.t0, self.t1 = t0_us, t1_us
        inside = [e for e in cpu if t0_us <= e[0] <= t1_us]
        calls = sorted((s, c, name) for s, _, name, c in inside if _API.match(name))
        steps = sorted((s, e) for s, e, name, _ in inside if name == step)
        self.lost = lost_records(records, calls, steps) if dev else []
        # busy_s stays as read, for the run's device line beside ``lost``
        self.device_events = [] if self.lost else dev
        self.busy = [] if self.lost else busy

    @property
    def whole(self) -> bool:
        """Device records were traced and none of the window's was lost."""
        return bool(self.device_events)

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
        open when it began, '|+<seconds into the window>'."""
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
            out.append([f"{sp}|{op}|+{(start - self.t0) / 1e6:.3f}s", length / 1e6])
        return out
