"""Profiling and tracing hooks.

Port of ``speech_decoding_tpu/utils/profiling.py``: ``trace(log_dir)``
records a ``torch.profiler`` trace (host ops, and the card's kernels and
copies when CUDA is available) into ``log_dir``, readable by TensorBoard's
profiler plugin or chrome://tracing; ``annotate(name)`` marks a named
region on that timeline; ``StepTimer`` gives the step-time and
items-per-second summary the Trainer and the tools report, with JAX's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` trace of the block, written into ``log_dir``
    (created if missing) as ``<worker>.<time>.pt.trace.json`` when the block
    ends; yields the profiler (its ``events()`` are there after the block).
    A no-op yielding None for a falsy ``log_dir``."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-clock step timer with throughput summary. Time work on a card
    up to a synchronisation (or a host read of its result): the host clock
    alone times the enqueue."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1) -> float:
        """Seconds since ``start``, recorded. ``items`` is kept for JAX's
        signature; ``summary`` takes the count."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop before start")
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_step_s": float(arr.mean()),
            "p50_step_s": float(np.percentile(arr, 50)),
            "p95_step_s": float(np.percentile(arr, 95)),
            "items_per_sec": float(items_per_step * len(arr) / arr.sum()),
        }
