"""Host-CPU M/EEG preprocessing: the numpy/scipy twin of the device
pipeline (band-pass FIR + MNE-grid FFT resample).

Port of ``speech_decoding_tpu/ops/brain_preproc_host.py``, copied unchanged
except that ``design_bandpass_fir`` comes from the port's ``ops/fir.py``: the
same numpy and scipy calls, so its output equals the JAX package's host twin
bit for bit.

The device path in ``ops/brain_preproc.py`` must ship raw 1 kHz recordings
to the card and back; the host path touches each sample in two FFT round
trips and ships nothing. The same MNE-default algorithm
([ref: dataclass/gwilliams2022.py:253-260, dataclass/brennan2018.py:263-272])
runs multi-threaded across recordings (scipy.fft releases the GIL) and
agrees with the device's exact-grid path
(``preprocess_batch(exact_grid=True)``) up to f32 FFT rounding.
``ops/preproc_dispatch.preprocess_auto`` routes recordings between the two.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import scipy.fft

from speech_decoding_tpu_torch.ops.fir import design_bandpass_fir

__all__ = [
    "usable_cpus",
    "reflect_limited_pad_np",
    "fir_filter_zero_phase_np",
    "fft_resample_np",
    "preprocess_host",
]


def usable_cpus() -> int:
    """CPUs this process may actually run on. ``os.cpu_count()`` reports the
    machine, not the grant — on a 128-core host pinned to one core it says
    128, which would size thread pools 128 wide and (worse) let the
    dispatcher take the mixed host+device split that a single core cannot
    pump. Two Linux mechanisms limit the grant and neither implies the other:
    ``sched_getaffinity`` (cpusets/affinity masks) and the cgroup-v2 CPU
    bandwidth quota (``cpu.max``, what ``docker --cpus=N`` sets, invisible to
    the affinity mask). Take the min of both."""
    try:
        n = len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        n = os.cpu_count() or 1
    q = _cgroup_cpu_quota()
    if q != float("inf"):
        n = min(n, max(1, int(q)))
    return n


def _cgroup_cpu_quota() -> float:
    """cgroup-v2 CPU bandwidth grant in CPUs (``cpu.max`` = "<quota_us>
    <period_us>" or "max <period_us>"), inf when unlimited/absent."""
    try:
        with open("/sys/fs/cgroup/cpu.max", "r") as f:
            quota, period = f.read().split()[:2]
        if quota != "max" and int(period) > 0:
            return int(quota) / int(period)
    except (OSError, ValueError, IndexError):  # cgroup v1 / no cgroup
        pass
    return float("inf")


def reflect_limited_pad_np(x: np.ndarray, n_pad: int) -> np.ndarray:
    """MNE 'reflect_limited' padding (odd reflection about the edge sample,
    zero-extended beyond one full reflection) — numpy twin of
    ``ops.fir.reflect_limited_pad``."""
    T = x.shape[-1]
    m = min(n_pad, T - 1)
    left = 2 * x[..., :1] - x[..., m:0:-1]
    right = 2 * x[..., -1:] - x[..., -2 : -m - 2 : -1]
    parts = [left, x, right]
    if n_pad > m:
        z = np.zeros(x.shape[:-1] + (n_pad - m,), x.dtype)
        parts = [z, *parts, z]
    return np.concatenate(parts, axis=-1)


def fir_filter_zero_phase_np(
    x: np.ndarray, taps: np.ndarray, workers: int = -1
) -> np.ndarray:
    """Zero-phase FFT application of odd symmetric FIR taps along the last
    axis — numpy twin of ``ops.fir.fir_filter_zero_phase`` (same pad, same
    pow2 FFT length, same group-delay crop), f32 end to end."""
    x = np.asarray(x, np.float32)
    taps = np.asarray(taps, np.float32)
    N = taps.shape[-1]
    assert N % 2 == 1, "zero-phase application requires odd-length taps"
    T = x.shape[-1]
    n_edge = N - 1
    xp = reflect_limited_pad_np(x, n_edge)
    conv_len = xp.shape[-1] + N - 1
    fft_len = 1 << max(conv_len - 1, 1).bit_length()
    X = scipy.fft.rfft(xp, n=fft_len, workers=workers)
    H = scipy.fft.rfft(taps, n=fft_len, workers=workers)
    y = scipy.fft.irfft(X * H, n=fft_len, workers=workers)
    start = (N - 1) // 2 + n_edge
    return y[..., start : start + T].astype(np.float32)


def _spectral_resize_real(X: np.ndarray, n_in: int, n_out: int) -> np.ndarray:
    """scipy.signal.resample's half-spectrum copy for real input (twin of the
    device ``_filter_resample_fused`` resize rules)."""
    Nm = min(n_in, n_out)
    nyq = Nm // 2 + 1
    Y = np.zeros(X.shape[:-1] + (n_out // 2 + 1,), X.dtype)
    Y[..., :nyq] = X[..., :nyq]
    if Nm % 2 == 0:
        if n_out < n_in:  # downsampling: fold the conjugate bin
            Y[..., Nm // 2] *= 2.0
        elif n_out > n_in:  # upsampling: split the source Nyquist bin
            Y[..., Nm // 2] *= 0.5
    return Y


def fft_resample_np(
    x: np.ndarray, up: float = 1.0, down: float = 1.0, workers: int = -1
) -> np.ndarray:
    """MNE-grid FFT resampling along the last axis — numpy twin of
    ``ops.resample.fft_resample`` (same npad='auto' pow2 pad, same
    reflect-limited extension, same crop; rfft half-spectrum instead of the
    device's full complex FFT — identical for real signals)."""
    if float(up) == float(down):
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float32)
    n = x.shape[-1]
    ratio = float(up) / float(down)
    n_out = int(round(ratio * n))
    min_add = min(n // 8, 100)
    total = 1 << max(n + min_add - 1, 1).bit_length()
    npad = total - n
    pad_l, pad_r = npad // 2, npad - npad // 2
    extra = max(pad_l, pad_r)
    big = reflect_limited_pad_np(x, extra)
    big = big[..., extra - pad_l : big.shape[-1] - (extra - pad_r)]
    n_big = big.shape[-1]
    n_big_out = int(round(ratio * n_big))
    X = scipy.fft.rfft(big, workers=workers)
    Y = _spectral_resize_real(X, n_big, n_big_out)
    y = scipy.fft.irfft(Y, n=n_big_out, workers=workers) * (n_big_out / n_big)
    to_l = int(round(ratio * pad_l))
    return y[..., to_l : to_l + n_out].astype(np.float32)


def preprocess_host(
    recordings: Sequence[np.ndarray],
    sfreq: float,
    l_freq: float,
    h_freq: float,
    out_rate: float,
    workers: Optional[int] = None,
) -> List[np.ndarray]:
    """Band-pass + resample a list of (C, T_i) recordings on the host CPU.

    Same contract as ``ops.brain_preproc.preprocess_batch(to_host=True)`` and
    the same numerics as its exact-grid path (per-recording MNE filter +
    resample grids). ``workers``: recording-level thread-pool width (defaults
    to the CPU count; scipy.fft releases the GIL, so threads scale). Within
    each recording the FFTs use all remaining cores when the pool is width 1.
    """
    if not recordings:
        return []
    ncpu = usable_cpus()
    pool_w = max(1, int(workers) if workers is not None else min(ncpu, len(recordings)))
    # within-recording FFT threads when the pool is 1-wide: pass the GRANT,
    # not scipy's -1 (which resolves to the machine-wide os.cpu_count() —
    # verified in scipy 1.17 — and would spawn 64 FFT threads on a 1-core
    # affinity grant, the oversubscription usable_cpus exists to prevent)
    fft_workers = ncpu if pool_w == 1 else 1
    taps = design_bandpass_fir(sfreq, l_freq, h_freq).astype(np.float32)
    down = float(sfreq) / float(out_rate)

    def _one(r: np.ndarray) -> np.ndarray:
        y = fir_filter_zero_phase_np(r, taps, workers=fft_workers)
        return fft_resample_np(y, up=1.0, down=down, workers=fft_workers)

    if pool_w == 1:
        return [_one(r) for r in recordings]
    with ThreadPoolExecutor(max_workers=pool_w) as ex:
        return list(ex.map(_one, recordings))
