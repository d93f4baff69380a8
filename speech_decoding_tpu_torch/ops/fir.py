"""Zero-phase FIR band-pass filtering as batched tensor ops.

Port of ``speech_decoding_tpu/ops/fir.py``: the replacement for
``mne.filter.filter_data`` in the reference's brain preprocessing
[ref: dataclass/brennan2018.py:263-265, dataclass/gwilliams2022.py:253-255].
The taps are designed on the host once (numpy/scipy, copied unchanged from
the JAX package); the filtering is one batched FFT convolution
(``torch.fft``, cuFFT on the card) over (recordings × channels × time).

Design follows MNE's defaults (fir_design='firwin', fir_window='hamming',
phase='zero', filter_length='auto', transition bandwidths 'auto'):

  * l_trans = min(max(0.25 * l_freq, 2 Hz), l_freq)
  * h_trans = min(max(0.25 * h_freq, 2 Hz), nyquist - h_freq)
  * total length = 3.3 * sfreq / min(l_trans, h_trans), forced odd
  * band-pass taps = centered lowpass(h_freq + h_trans/2, len 3.3*sfreq/h_trans)
                   - centered lowpass(l_freq - l_trans/2, len 3.3*sfreq/l_trans)
  * zero-phase: odd-symmetric taps applied centered (group delay compensated),
    with MNE's 'reflect_limited' (odd-reflection) edge padding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.signal
import torch

_HAMMING_LENGTH_FACTOR = 3.3  # MNE's length factor for the hamming window


def _odd(n: int) -> int:
    return n + 1 - (n % 2)


def _centered_lowpass(cutoff_hz: float, n_taps: int, total_len: int, sfreq: float) -> np.ndarray:
    h = scipy.signal.firwin(
        n_taps, cutoff_hz, window="hamming", pass_zero=True, fs=sfreq
    )
    out = np.zeros(total_len)
    offset = (total_len - n_taps) // 2
    out[offset : offset + n_taps] = h
    return out


def design_bandpass_fir(
    sfreq: float, l_freq: Optional[float], h_freq: Optional[float]
) -> np.ndarray:
    """MNE-default band-pass (or low/high-pass if one edge is None) FIR taps."""
    nyq = sfreq / 2.0
    l_trans = h_trans = None
    if l_freq is not None:
        l_trans = min(max(0.25 * l_freq, 2.0), l_freq)
    if h_freq is not None:
        h_trans = min(max(0.25 * h_freq, 2.0), nyq - h_freq)

    trans = [t for t in (l_trans, h_trans) if t is not None]
    if not trans:
        raise ValueError("at least one of l_freq/h_freq required")
    N = _odd(int(round(_HAMMING_LENGTH_FACTOR * sfreq / min(trans))))

    if h_freq is not None:
        n_h = _odd(int(round(_HAMMING_LENGTH_FACTOR * sfreq / h_trans)))
        lp_h = _centered_lowpass(h_freq + h_trans / 2.0, min(n_h, N), N, sfreq)
    else:
        lp_h = np.zeros(N)
        lp_h[N // 2] = 1.0  # all-pass
    if l_freq is not None:
        n_l = _odd(int(round(_HAMMING_LENGTH_FACTOR * sfreq / l_trans)))
        lp_l = _centered_lowpass(l_freq - l_trans / 2.0, min(n_l, N), N, sfreq)
    else:
        lp_l = np.zeros(N)
    return (lp_h - lp_l).astype(np.float64)


def reflect_limited_pad(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """MNE 'reflect_limited' padding on the last axis: odd reflection about
    the edge sample (2*edge - x reversed). Beyond one full reflection
    (n_pad > T-1) the pad is zero-extended, as MNE's ``_smart_pad`` does, so
    the result always has T + 2*n_pad samples."""
    T = x.shape[-1]
    m = min(n_pad, T - 1)
    left = 2 * x[..., :1] - torch.flip(x[..., 1 : m + 1], [-1])
    right = 2 * x[..., -1:] - torch.flip(x[..., T - 1 - m : T - 1], [-1])
    parts = [left, x, right]
    if n_pad > m:
        z = x.new_zeros(x.shape[:-1] + (n_pad - m,))
        parts = [z, *parts, z]
    return torch.cat(parts, dim=-1)


def fir_filter_zero_phase(x: torch.Tensor, taps, pad: bool = True) -> torch.Tensor:
    """Apply odd-length symmetric FIR taps zero-phase by FFT convolution.

    x: (..., T); taps: (N,) with N odd (numpy or tensor). Batched over all
    leading axes; computed in f32 on x's device."""
    x = x.float()
    taps = torch.as_tensor(taps).to(x.device, torch.float32)
    N = taps.shape[-1]
    if N % 2 != 1:
        raise ValueError("zero-phase application requires odd-length taps")
    T = x.shape[-1]
    # full N-1 edge pad like MNE (zero-extended beyond one reflection for
    # T <= N-1): the FFT convolution then never wraps into the signal
    n_edge = N - 1 if pad else 0
    if pad:
        x = reflect_limited_pad(x, n_edge)
    # linear convolution length, rounded up to a power of two for the FFT
    conv_len = x.shape[-1] + N - 1
    fft_len = 1 << max(conv_len - 1, 1).bit_length()
    X = torch.fft.rfft(x, n=fft_len)
    H = torch.fft.rfft(taps, n=fft_len)
    y = torch.fft.irfft(X * H, n=fft_len)
    # compensate the (N-1)/2 group delay, then strip the padding
    start = (N - 1) // 2 + n_edge
    return y[..., start : start + T].contiguous()


def bandpass_filter(
    x: torch.Tensor, sfreq: float, l_freq: Optional[float], h_freq: Optional[float]
) -> torch.Tensor:
    """Design + apply in one call (the mne.filter.filter_data equivalent)."""
    return fir_filter_zero_phase(x, design_bandpass_fir(sfreq, l_freq, h_freq))
