"""Resampling as tensor ops: MNE-style FFT resampling for brain signals and
embeddings, and torchaudio-style windowed-sinc polyphase resampling for audio.

Port of ``speech_decoding_tpu/ops/resample.py``. Replaces:
  * ``mne.filter.resample`` — EEG/MEG down-sampling to 120 Hz and embedding
    up-sampling [ref: dataclass/brennan2018.py:197-201,267-272,
    dataclass/gwilliams2022.py:258-260,369-373];
  * ``torchaudio.functional.resample(…, lowpass_filter_width=128)`` — audio to
    16 kHz before wav2vec2 [ref: dataclass/brennan2018.py:171-172,
    dataclass/gwilliams2022.py:349-354].

``fft_resample`` follows MNE's method='fft' algorithm: odd-reflection
('reflect_limited') padding to the next power of two, spectral
truncation/extension with scipy.signal.resample's Nyquist-bin handling
(boxcar window), then cropping round(ratio * pad) from the left. It runs a
full complex FFT in complex64 (``torch.fft``, cuFFT on the card). Its output
length round(ratio * n_big) can be any integer, prime included, where cuFFT
takes its slower Bluestein path.

``sinc_resample`` follows torchaudio's sinc_interp_hann kernel construction
(gcd-reduced polyphase, hann^2-windowed sinc, rolloff 0.99) applied as one
strided ``F.conv1d`` (cuDNN on the card, in f32: never TF32).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops.fir import reflect_limited_pad
from speech_decoding_tpu_torch.utils.device import exact_f32


# ---------------------------------------------------------------------------
# MNE-style FFT resample
# ---------------------------------------------------------------------------


def _auto_pad(n: int) -> Tuple[int, int]:
    """MNE npad='auto': pad to the next power of two past n + min(n//8, 100)."""
    min_add = min(n // 8, 100)
    total = 1 << max(n + min_add - 1, 1).bit_length()
    npad = total - n
    return npad // 2, npad - npad // 2


def _spectral_resize(X: torch.Tensor, n_in: int, n_out: int) -> torch.Tensor:
    """scipy.signal.resample spectrum copy (full complex FFT convention)."""
    N = min(n_in, n_out)
    nyq = N // 2 + 1
    Y = X.new_zeros(X.shape[:-1] + (n_out,))
    Y[..., :nyq] = X[..., :nyq]
    if N > 2:
        neg = N - nyq
        Y[..., n_out - neg :] = X[..., n_in - neg :]
    if N % 2 == 0:
        half = N // 2
        if n_out < n_in:  # downsampling: fold the two source bins
            Y[..., half] *= 2.0
        elif n_out > n_in:  # upsampling: split the source Nyquist bin
            Y[..., half] *= 0.5
            Y[..., n_out - half] = Y[..., half]
    return Y


def fft_resample(x, up: float = 1.0, down: float = 1.0) -> torch.Tensor:
    """MNE-equivalent FFT resampling along the last axis, in f32 on x's
    device. Output length = round(len * up / down). Batched over leading
    axes. ``up == down`` returns x as f32 at once."""
    x = torch.as_tensor(x).float()
    if float(up) == float(down):
        return x
    n = x.shape[-1]
    ratio = float(up) / float(down)
    n_out = int(round(ratio * n))
    pad_l, pad_r = _auto_pad(n)
    # odd-reflection padding on both sides (MNE pad='reflect_limited');
    # reflect_limited_pad pads symmetrically, trim to the exact l/r split
    extra = max(pad_l, pad_r)
    big = reflect_limited_pad(x, extra)
    big = big[..., extra - pad_l : big.shape[-1] - (extra - pad_r)]
    n_big = big.shape[-1]
    n_big_out = int(round(ratio * n_big))

    X = torch.fft.fft(big.to(torch.complex64))
    Y = _spectral_resize(X, n_big, n_big_out)
    y = torch.fft.ifft(Y).real * (n_big_out / n_big)

    to_l = int(round(ratio * pad_l))
    return y[..., to_l : to_l + n_out].contiguous()


# ---------------------------------------------------------------------------
# torchaudio-style windowed-sinc polyphase resample
# ---------------------------------------------------------------------------


def _sinc_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float
) -> Tuple[np.ndarray, int]:
    """torchaudio _get_sinc_resample_kernel (sinc_interp_hann): returns
    (kernel (new_g, taps), width) with freqs reduced by their gcd."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window
    kernel *= base_freq / orig_freq
    return kernel.astype(np.float32), width


def sinc_resample(
    x,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """Windowed-sinc resampling along the last axis (torchaudio
    sinc_interp_hann algorithm), in f32 on x's device.
    x: (..., T) -> (..., ceil(T * new / orig))."""
    x = torch.as_tensor(x).float()
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    of, nf = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _sinc_kernel(of, nf, lowpass_filter_width, rolloff)

    lead = x.shape[:-1]
    T = x.shape[-1]
    target_len = int(math.ceil(nf * T / of))
    xx = Fn.pad(x.reshape(-1, 1, T), (width, width + of))  # (N, 1, T + pad)
    # one strided conv produces all nf polyphase outputs as channels
    w = torch.from_numpy(kernel).to(x.device)[:, None, :]  # (nf, 1, taps)
    with exact_f32():
        y = Fn.conv1d(xx, w, stride=of)  # (N, nf, frames)
    y = y.transpose(1, 2).reshape(y.shape[0], -1)[:, :target_len]
    return y.reshape(lead + (target_len,))
