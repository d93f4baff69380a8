"""Measurement and validation tools of the port, run as modules
(``python -m speech_decoding_tpu_torch.tools.<name>``), and the timing
helpers they share."""

from __future__ import annotations

import time
from typing import Callable

import torch


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def seconds_for(fn: Callable[[], object], dev: torch.device, reps: int) -> float:
    """Seconds for ``reps`` calls of ``fn``: CUDA events on a card, the host
    clock on the CPU (a host timing, never a device number)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3
