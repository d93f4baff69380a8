"""Sharded brain preprocessing over the ranks of a ``DataGroup``.

Port of ``speech_decoding_tpu/parallel/preproc_sharded.py``. JAX runs each
function under ``shard_map`` on a mesh; here each rank passes its own block
and gets its own block back, on the group's device:

  * ``bandpass_filter_sharded``: a recording whose TIME axis is split over
    the ranks (rank r holds samples [r·t, (r+1)·t)). FIR filtering is local
    with a halo: each rank sends its (taps − 1)/2 edge samples to its
    neighbours, the first and last rank build the reflect-limited pad of
    the recording's own edges, so the result equals the one-process
    ``ops.fir.bandpass_filter`` up to the FFT's rounding. It bounds each
    card's memory for recordings of any length (a Gwilliams recording is
    (208, ~396,000) samples at 1000 Hz [ref: gwilliams2022.py:249]).
  * ``fft_resample_sharded`` and ``bandpass_resample_sharded``: the CHANNEL
    axis split. Both stages are per channel, so channel sharding is the
    caller's own slice of the channels plus the one-process chain
    (``ops.fir``, ``ops.resample.fft_resample``) on the group's device, with
    no communication; the two functions are that chain under JAX's names.

The halo crosses ranks in one all-gather of every rank's two edges
(C × 2·halo floats a rank), which every backend runs on CUDA and CPU
tensors alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from speech_decoding_tpu_torch.ops.fir import design_bandpass_fir, fir_filter_zero_phase
from speech_decoding_tpu_torch.ops.resample import fft_resample
from speech_decoding_tpu_torch.parallel.collectives import all_gather_stack
from speech_decoding_tpu_torch.parallel.mesh import DataGroup


def bandpass_filter_sharded(x, sfreq: float, l_freq: Optional[float], h_freq: Optional[float],
                            group: DataGroup) -> torch.Tensor:
    """This rank's block (..., t) of the band-passed recording, from its
    block ``x`` (..., t) of the time axis (f32, on the group's device).
    Every rank's t must be equal and exceed the filter's half-length (JAX's
    asserts; checked with one all-gather, so every rank raises together)."""
    taps = design_bandpass_fir(sfreq, l_freq, h_freq)
    halo = (len(taps) - 1) // 2
    x = torch.as_tensor(x).to(group.device, torch.float32).contiguous()
    t = x.shape[-1]
    lengths = all_gather_stack(torch.tensor([t], dtype=torch.int64, device=group.device), group).flatten().tolist()
    if len(set(lengths)) != 1:
        raise ValueError(f"every rank's block must have the same length, got {lengths}")
    if t <= halo:
        raise ValueError(f"block length {t} must exceed the filter half-length {halo}")
    edges = all_gather_stack(torch.stack([x[..., :halo], x[..., -halo:]]), group)  # (W, 2, ..., halo)
    r = group.rank
    # the left neighbour's right edge and the right neighbour's left edge;
    # at the recording's own edges, the reflect-limited extension that
    # fir_filter_zero_phase pads with (2·edge − the mirrored samples)
    from_left = edges[r - 1, 1] if r > 0 else 2 * x[..., :1] - x[..., 1 : halo + 1].flip(-1)
    from_right = edges[r + 1, 0] if r < group.world - 1 else 2 * x[..., -1:] - x[..., -halo - 1 : -1].flip(-1)
    y = fir_filter_zero_phase(torch.cat([from_left, x, from_right], dim=-1), taps, pad=False)
    return y[..., halo : halo + t].contiguous()


def fft_resample_sharded(x, up: float, down: float, group: DataGroup) -> torch.Tensor:
    """``ops.resample.fft_resample`` of this rank's channel block ``x``
    (C_block, ..., T) on the group's device; the resample's FFT couples
    every time sample, so the channel axis is the one split (JAX's
    docstring, ``preproc_sharded.py:77-90``)."""
    return fft_resample(torch.as_tensor(x).to(group.device), up=up, down=down)


def bandpass_resample_sharded(x, sfreq: float, l_freq: Optional[float], h_freq: Optional[float],
                              new_rate: float, group: DataGroup) -> torch.Tensor:
    """The brain DSP chain (band-pass, then resample [ref:
    gwilliams2022.py:253-260]) on this rank's channel block ``x`` (C_block,
    T): (C_block, round(T · new_rate / sfreq)), on the group's device."""
    x = torch.as_tensor(x).to(group.device, torch.float32)
    y = fir_filter_zero_phase(x, design_bandpass_fir(sfreq, l_freq, h_freq))
    return fft_resample(y, up=new_rate, down=sfreq)
