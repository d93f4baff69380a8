"""The three weight gradients of a dilated k=3 'SAME' conv in one pass.

Port of ``speech_decoding_tpu/ops/pallas/tap_conv.py``, K2 (``tap_conv_dw``):

    dW_j = Σ_{b,t} x[b, t+(j−1)d]ᵀ g[b, t],  j = 0, 1, 2,

with rows of x outside [0, T) read as zero. The backward of every k=3 conv
of the encoder (``models.brain_encoder.TapConv``) computes its dW here. The
CUDA kernel (``csrc/tap_conv_dw.cu``) reads x and g once per block, splits
the batch rows across blocks and adds the per-split f32 partials in a fixed
order, so two runs on the same inputs give the same bits. bf16 runs on the
tensor cores, f32 on the CUDA cores.

``tap_conv_dw`` launches the kernel for CUDA tensors and uses
``tap_conv_dw_plain`` for CPU tensors; it never falls back on the card.

K5 (the fused 3-tap conv forward, ``tap_conv`` / ``pallas_tap_conv``,
opt-in ``conv_impl="pallas_taps"``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_TILE = 64  # channels per block on each side (csrc/tap_conv_dw.cu TI, TO)


def tap_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, dilation: int) -> torch.Tensor:
    """Reference: three shifted einsums accumulated in f32. x (B, T, Cin),
    g (B, T, Cout) -> (3, Cin, Cout) f32."""
    B, T, Cin = x.shape
    d = dilation
    xp = Fn.pad(x.float(), (0, 0, d, d))
    gf = g.float().reshape(B * T, -1)
    taps = [xp[:, j * d : j * d + T].reshape(B * T, Cin).T @ gf for j in range(3)]
    return torch.stack(taps)


def _splits(B: int, Cin: int, Cout: int, device: torch.device) -> int:
    """Batch-row splits: about three blocks per SM over the whole grid."""
    tiles = math.ceil(Cin / _TILE) * math.ceil(Cout / _TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(B, math.ceil(3 * sms / tiles)))


def _launch(x: torch.Tensor, g: torch.Tensor, d: int) -> torch.Tensor:
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"tap_conv_dw takes float32 or bfloat16 x and g of one dtype, got {x.dtype}, {g.dtype}")
    if not (g.is_cuda and g.device == x.device):
        raise ValueError("tap_conv_dw: x and g must lie on one CUDA device")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("tap_conv_dw takes contiguous tensors")
    B, T, Cin = x.shape
    Cout = g.shape[2]
    out = torch.empty((3, Cin, Cout), dtype=torch.float32, device=x.device)
    if B * T == 0:
        return out.zero_()
    nsplit = _splits(B, Cin, Cout, x.device)
    part = torch.empty((nsplit, 3, math.ceil(Cin / _TILE) * _TILE, math.ceil(Cout / _TILE) * _TILE),
                       dtype=torch.float32, device=x.device)
    fn = getattr(_build.load("tap_conv_dw"), f"tap_conv_dw_{_DTYPES[x.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), B, T, Cin, Cout, d, nsplit, stream)
    _build.check(err, f"tap_conv_dw d={d}")
    tap_conv_dw.launches += 1
    return out


def tap_conv_dw(x: torch.Tensor, g: torch.Tensor, dilation: int) -> torch.Tensor:
    """(3, Cin, Cout) f32 weight gradients of the dilated k=3 conv whose input
    is x (B, T, Cin) and whose output cotangent is g (B, T, Cout)."""
    if x.dim() != 3 or g.dim() != 3 or x.shape[:2] != g.shape[:2]:
        raise ValueError(f"tap_conv_dw shapes: x (B, T, Cin), g (B, T, Cout); got {tuple(x.shape)}, {tuple(g.shape)}")
    if int(dilation) != dilation or dilation < 1:
        raise ValueError(f"tap_conv_dw needs an integer dilation >= 1, got {dilation}")
    if x.is_cuda:
        return _launch(x, g, int(dilation))
    if x.device.type != "cpu":
        raise ValueError(f"tap_conv_dw runs on CUDA or CPU tensors, got {x.device}")
    return tap_conv_dw_plain(x, g, int(dilation))


tap_conv_dw.launches = 0  # kernel launches (CUDA tensors only)
