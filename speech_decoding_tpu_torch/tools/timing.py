"""Timing helpers of the op benchmarks (``tools.bench_batchnorm_gelu``,
``tools.bench_glu``): CUDA events over back-to-back calls, the device time
of each kernel from a ``torch.profiler`` trace, and the card's HBM peak that
a byte-bound op's bound is computed at.

The benchmark's yardstick (``port_bench/flops.py``) states the same peak on
its own, as it reads nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def events_ms(fn, warmup: int = 5, n: int = 50, rounds: int = 3) -> float:
    """The best of ``rounds`` CUDA-event timings of ``n`` back-to-back calls, per call."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def device_ms(fn, reps: int = 10) -> Optional[Dict[str, float]]:
    """Device ms per call from a ``torch.profiler`` trace of ``reps`` calls:
    the total, the kernel records a call and each kernel's ms (by its name
    up to the argument list); None if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by: Dict[str, float] = {}
    records = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.split("(")[0][:60]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
            records += 1
    if not by:
        return None
    return {"total": sum(by.values()), "records": records / reps, "by_kernel": by}
