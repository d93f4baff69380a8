"""Robust scaling, clamping and baseline correction as batched tensor ops.

Port of ``speech_decoding_tpu/ops/scaling.py``: the Gwilliams collator
(baseline-correct, robust-scale, clamp [ref: gwilliams2022.py:653-661]) as
device compute inside the train step, and its precomputed-stats form
(``window_scale_stats`` once per segment, ``apply_scale_stats`` per step).

Parity notes: sklearn's RobustScaler centres on the median and scales by the
(25, 75) IQR of linear-interpolation quantiles, with zero IQRs replaced by 1
(sklearn ``_handle_zeros_in_scale``). The quartiles interpolate linearly
between neighbours of one sort, as ``jnp.percentile`` does by default
(``torch.quantile`` computes the same but refuses inputs of more than 2²⁴
elements, which a test set of windows exceeds).
"""

from __future__ import annotations

import math

import torch


def _quartile(s: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """Linear-interpolation quantile q of values sorted along ``dim``."""
    pos = q * (s.shape[dim] - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, s.shape[dim] - 1)
    return torch.lerp(s.narrow(dim, lo, 1), s.narrow(dim, hi, 1), pos - lo)


def _quartiles(x: torch.Tensor, dim: int, keepdim: bool):
    s = torch.sort(x, dim=dim).values
    q25, q50, q75 = (_quartile(s, q, dim) for q in (0.25, 0.5, 0.75))
    if not keepdim:
        q25, q50, q75 = (v.squeeze(dim) for v in (q25, q50, q75))
    iqr = q75 - q25
    iqr = torch.where(iqr.abs() < 1e-12, torch.ones_like(iqr), iqr)  # sklearn zero-scale rule
    return q50, iqr


def robust_scale(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """(x - median) / IQR along ``axis`` in f32 (sklearn RobustScaler)."""
    x = x.float()
    med, iqr = _quartiles(x, axis, keepdim=True)
    return (x - med) / iqr


def clamp(x: torch.Tensor, lim: float) -> torch.Tensor:
    """Symmetric clamp to ±lim [ref: brennan2018.py:124]."""
    return torch.clamp(x, -lim, lim)


def baseline_correct(x: torch.Tensor, baseline_len_samp: int) -> torch.Tensor:
    """Subtract the mean of the first ``baseline_len_samp`` samples of each
    (…, channel) row. x: (..., C, T)."""
    return x - x[..., :baseline_len_samp].mean(dim=-1, keepdim=True)


def gwilliams_collate(X: torch.Tensor, baseline_len_samp: int, clamp_lim: float,
                      do_clamp: bool = True) -> torch.Tensor:
    """Baseline-correct, robust-scale and clamp each (segment, channel)
    window. X: (B, C, T)."""
    X = robust_scale(baseline_correct(X, baseline_len_samp), axis=-1)
    return clamp(X, clamp_lim) if do_clamp else X


def window_scale_stats(windows: torch.Tensor) -> torch.Tensor:
    """(..., C, 2) [median, IQR] over the time axis of (..., C, T) windows
    (zero IQRs replaced by 1), computed once per segment so the per-step
    collate needs no sort."""
    med, iqr = _quartiles(windows.float(), -1, keepdim=False)
    return torch.stack([med, iqr], dim=-1)


def apply_scale_stats(X: torch.Tensor, stats: torch.Tensor, clamp_lim: float,
                      do_clamp: bool = True, channels_last: bool = False) -> torch.Tensor:
    """clip((X - median) / IQR) from precomputed stats; equals
    ``gwilliams_collate`` on the same windows (the baseline cancels inside
    the median). X (B, C, T), or (B, T, C) with ``channels_last``; stats
    (B, C, 2)."""
    if channels_last:
        med, iqr = stats[..., 0][:, None, :], stats[..., 1][:, None, :]
    else:
        med, iqr = stats[..., 0:1], stats[..., 1:2]
    Y = (X.float() - med) / iqr
    return clamp(Y, clamp_lim) if do_clamp else Y
