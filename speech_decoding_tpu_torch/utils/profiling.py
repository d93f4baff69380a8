"""Profiling and tracing hooks.

Port of ``speech_decoding_tpu/utils/profiling.py``: ``trace(log_dir)``
records a ``torch.profiler`` trace (host ops, and the card's kernels and
copies when CUDA is available) into ``log_dir``, readable by TensorBoard's
profiler plugin or chrome://tracing. ``annotate(name)`` is the port's one
span: free while no profiler records, and while one does, a
``record_function`` range on the profiler's timeline and an entry in a
bounded span log (``span_log()``) on the clock the profiler stamps its
events with. The log carries the spans of every thread: the profiler
records only the thread that started it. ``SPANS`` names the spans the
port opens.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# The port's spans (thread: where), read by port_bench/program_spans.py
STEP = "sd.step"  # main: training/steps.py train_step, zero_grad to the metrics dict
STEP_FORWARD = "sd.step.forward"  # main: collate, encoder and loss
STEP_BACKWARD = "sd.step.backward"  # main: loss.backward() and, under a group, the gradient all-reduce
STEP_OPTIMIZER = "sd.step.optimizer"  # main: the optimizer's step
STEP_GRAPH = "sd.step.graph"  # main: a replayed step's input copies and replay (no forward or backward span then)
LOOP_WAIT = "sd.loop.wait"  # main: data/native_loader.py Prefetcher, the loop waiting for a batch
LOOP_STACK = "sd.loop.stack"  # producer: training/trainer.py Trainer._grouped, stacking a scan group
DATA_INDEX = "sd.data.index"  # producer: data/device_resident.py make_index_batch
DATA_GATHER = "sd.data.gather"  # producer: data/device_resident.py gather
SPANS = (STEP, STEP_FORWARD, STEP_BACKWARD, STEP_OPTIMIZER, STEP_GRAPH, LOOP_WAIT, LOOP_STACK, DATA_INDEX,
         DATA_GATHER)

SPAN_LOG_MAXLEN = 100_000


class Span(NamedTuple):
    """One closed span: its name, its thread's name, and its start and end
    in ``time.time_ns()`` nanoseconds (the profiler's event clock)."""

    name: str
    thread: str
    start_ns: int
    end_ns: int


class SpanLog:
    """Spans in the order they closed, at most ``maxlen``: once full, each
    new span drops the oldest, and ``dropped`` counts them."""

    def __init__(self, maxlen: int = SPAN_LOG_MAXLEN):
        self._spans: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


_LOG = SpanLog()
_OFF = contextlib.nullcontext()


def span_log() -> SpanLog:
    """The process's span log: spans opened while a profiler recorded."""
    return _LOG


def clear_span_log() -> None:
    _LOG.clear()


class _Span:
    __slots__ = ("_name", "_range", "_start")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self) -> None:
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._start = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self._range.__exit__(*exc)
        _LOG.add(Span(self._name, threading.current_thread().name, self._start, end))


def annotate(name: str):
    """A named span around a block. While no profiler records, a shared
    null context (no ``record_function``, no clock read); while one does,
    a ``record_function`` range and an entry in ``span_log()``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


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
