"""The dilated k=3 'SAME' conv (K5) and its three weight gradients in one
pass (K2).

Port of ``speech_decoding_tpu/ops/pallas/tap_conv.py``. K5 (``tap_conv``,
the encoder's opt-in ``conv_impl="pallas_taps"``):

    y[b, t] = Σ_j x[b, t+(j−1)d] @ W_j,  j = 0, 1, 2,

zero padding at each recording's edges, f32 accumulation of all three taps
and one cast to x's dtype (the ``gemm`` path's ``TapConv`` rounds each tap's
product to x's dtype instead, so the two differ at bf16 rounding). The CUDA
kernel (``csrc/tap_conv.cu``) is the conv tile of ``csrc/tap3.cuh``, shared
with K6. ``PallasTapConv`` is the JAX ``pallas_tap_conv`` custom VJP: dx is
K5 on the tap-reversed, transposed weights, dW is K2. Like the JAX kernel,
K5 takes 0 < d < T only.

K2 (``tap_conv_dw``):

    dW_j = Σ_{b,t} x[b, t+(j−1)d]ᵀ g[b, t],  j = 0, 1, 2,

with rows of x outside [0, T) read as zero. The backward of every k=3 conv
of the encoder (``models.brain_encoder.TapConv``, ``PallasTapConv``, and the
B1, B2 and B3 stages of K6) computes its dW here. The
CUDA kernel (``csrc/tap_conv_dw.cu``) reads x and g once per block, splits
the batch rows across blocks and adds the per-split f32 partials in a fixed
order, so two runs on the same inputs give the same bits. bf16 runs on the
tensor cores, f32 on the CUDA cores.

``tap_conv`` and ``tap_conv_dw`` launch their kernels for CUDA tensors and
use ``tap_conv_plain`` / ``tap_conv_dw_plain`` for CPU tensors; they never
fall back on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops.conv_block import _conv3

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


def tap_conv_plain(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Reference: the three shifted tap products summed in f32, one cast to
    x's dtype. x (B, T, Cin), w (3, Cin, Cout) -> (B, T, Cout)."""
    return _conv3(x, w, dilation).to(x.dtype)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"tap_conv takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if not (w.is_cuda and w.device == x.device):
        raise ValueError("tap_conv: x and w must lie on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tap_conv takes contiguous tensors")
    B, T, Cin = x.shape
    Cout = w.shape[2]
    y = torch.empty((B, T, Cout), dtype=x.dtype, device=x.device)
    fn = getattr(_build.load("tap_conv"), f"tap_conv_{_DTYPES[x.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, Cin, Cout, d, stream)
    _build.check(err, f"tap_conv d={d}")
    tap_conv.launches += 1
    return y


def tap_conv(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """(B, T, Cout) dilated k=3 'SAME' conv of x (B, T, Cin) with w (3, Cin,
    Cout) in x's dtype, f32 accumulation. Raises ValueError unless
    0 < dilation < T, the domain of the JAX kernel."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"tap_conv shapes: x (B, T, Cin), w (3, Cin, Cout); got {tuple(x.shape)}, {tuple(w.shape)}")
    if int(dilation) != dilation or not 0 < dilation < x.shape[1]:
        raise ValueError(f"tap_conv needs an integer dilation in (0, T={x.shape[1]}), got {dilation}")
    if x.is_cuda:
        return _launch_conv(x, w, int(dilation))
    if x.device.type != "cpu":
        raise ValueError(f"tap_conv runs on CUDA or CPU tensors, got {x.device}")
    return tap_conv_plain(x, w, int(dilation))


tap_conv.launches = 0  # kernel launches (CUDA tensors only)


def flip_taps(w: torch.Tensor) -> torch.Tensor:
    """(3, Cin, Cout) -> (3, Cout, Cin): the tap-reversed, transposed weights
    whose 'SAME' conv with the same dilation is the transposed conv."""
    return w.flip(0).transpose(1, 2).contiguous()


class PallasTapConv(torch.autograd.Function):
    """The JAX ``pallas_tap_conv`` custom VJP (``tap_conv.py:191-212`` of the
    JAX package): forward K5; dx = K5 on ``flip_taps(W)``; dW = K2, cast to
    W's dtype."""

    @staticmethod
    def forward(ctx, x, w, dilation: int):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return tap_conv(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        g = g.to(x.dtype).contiguous()
        dx = tap_conv(g, flip_taps(w), d) if ctx.needs_input_grad[0] else None
        dw = tap_conv_dw(x, g, d).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None
