"""The dilated k=3 'SAME' conv (K5) and its three weight gradients in one
pass (K2).

Port of ``speech_decoding_tpu/ops/pallas/tap_conv.py``. K5 (``tap_conv``,
the encoder's opt-in ``conv_impl="pallas_taps"``):

    y[b, t] = Σ_j x[b, t+(j−1)d] @ W_j,  j = 0, 1, 2,

zero padding at each recording's edges, f32 accumulation of all three taps
and one cast to x's dtype (the ``gemm`` path's ``TapConv`` adds the taps
inside cuBLAS on the card, one GEMM a tap, rounding to x's dtype after
each, and on the CPU rounds each tap's product and each sum; so the paths
differ at bf16 rounding).
``PallasTapConv`` is the JAX ``pallas_tap_conv`` custom VJP: dx is K5 on the
tap-reversed, transposed weights (``tap_conv_transposed``), dW is K2. Like the JAX kernel, K5 takes
0 < d < T only.

K2 (``tap_conv_dw``):

    dW_j = Σ_{b,t} x[b, t+(j−1)d]ᵀ g[b, t],  j = 0, 1, 2,

with rows of x outside [0, T) read as zero. The backward of every k=3 conv
of the encoder (``models.brain_encoder.TapConv``, ``PallasTapConv``, and the
B1, B2 and B3 stages of K6) computes its dW here.

Both are bound by operations on the card. In bf16 each runs ``wgmma`` on
tiles that TMA brings in from 3-D (C, T, B) tensor maps (``csrc/hopper.cuh``),
whose out-of-range rows read as zero: the 'SAME' padding comes from the map.
K5 (``csrc/tap_conv.cu``) is an implicit GEMM over (tap, 64-channel chunk)
with K-major weights; K2 (``csrc/tap_conv_dw.cu``) gives each tap its own
warpgroup and accumulator over one staged g tile, splits the recordings
across blocks and adds the per-split f32 partials in a fixed order, so two
runs on the same inputs give the same bits. TMA needs 16-byte row strides
and bases, so the wrappers hand the kernels ``pad_channels`` copies (channels
zero-padded to a multiple of 8, e.g. 270 → 272, or a misaligned base copied)
and K5 its weights through ``pack_weights`` (for dx straight from
``w.flip(0)``, one copy); both are plain PyTorch and the CPU tests hold them. f32 runs on the CUDA cores (K5 on the tile of
``csrc/tap3.cuh``, shared with K6).

``tap_conv`` and ``tap_conv_dw`` launch their kernels for CUDA tensors and
use ``tap_conv_plain`` / ``tap_conv_dw_plain`` for CPU tensors; they never
fall back on the card.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import INT, PTR

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K2's tile (ci, co) per block: csrc/tap_conv_dw.cu TI, TO (f32) and dwb::TM, dwb::TN (bf16)
_DW_TILE = {torch.float32: (64, 64), torch.bfloat16: (64, 128)}
DW_LIB = _build.Library("tap_conv_dw", {"tap_conv_dw_f32": [PTR] * 4 + [INT] * 6,
                                        "tap_conv_dw_bf16": [PTR] * 4 + [INT] * 8})
LIB = _build.Library("tap_conv", {"tap_conv_f32": [PTR] * 3 + [INT] * 5, "tap_conv_bf16": [PTR] * 3 + [INT] * 6})


def pad_channels(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., C) as TMA reads it: contiguous, the last dim zero-padded to
    a multiple of 8 (16-byte bf16 rows), the base 16-byte aligned. ``t``
    itself when it already is; otherwise a fresh copy (270 channels → 272)."""
    pad = -t.shape[-1] % 8
    if pad:
        return Fn.pad(t, (0, pad)).contiguous()
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def pack_weights(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """K5's weights (3, Cin, Cout) in the K-major form its kernel reads, the
    conv's input channels zero-padded to a multiple of 8 in the same copy:
    (3, Cout, Cin8) with ``[j, co, ci] = w[j, ci, co]``; with ``transposed``,
    those of the conv with ``flip_taps(w)`` (the dx conv), which are
    ``w.flip(0)``: (3, Cin, Cout8), one copy."""
    return pad_channels(w.flip(0) if transposed else w.transpose(1, 2))


def tap_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, dilation: int) -> torch.Tensor:
    """Reference: three shifted einsums accumulated in f32. x (B, T, Cin),
    g (B, T, Cout) -> (3, Cin, Cout) f32."""
    B, T, Cin = x.shape
    d = dilation
    xp = Fn.pad(x.float(), (0, 0, d, d))
    gf = g.float().reshape(B * T, -1)
    taps = [xp[:, j * d : j * d + T].reshape(B * T, Cin).T @ gf for j in range(3)]
    return torch.stack(taps)


def _splits(B: int, Cin: int, Cout: int, device: torch.device, dtype: torch.dtype) -> int:
    """Batch-row splits. f32: about three blocks per SM over the whole grid;
    bf16 (one block per SM): as many as one wave holds."""
    ti, to = _DW_TILE[dtype]
    tiles = math.ceil(Cin / ti) * math.ceil(Cout / to)
    sms = _build.sms(device)
    n = math.ceil(3 * sms / tiles) if dtype == torch.float32 else sms // tiles
    return max(1, min(B, n))


def _launch(x: torch.Tensor, g: torch.Tensor, d: int, padded=None) -> torch.Tensor:
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
    nsplit = _splits(B, Cin, Cout, x.device, x.dtype)
    ti, to = _DW_TILE[x.dtype]
    part = torch.empty((nsplit, 3, math.ceil(Cin / ti) * ti, math.ceil(Cout / to) * to),
                       dtype=torch.float32, device=x.device)
    if x.dtype == torch.float32:
        DW_LIB("tap_conv_dw_f32", x.device, x, g, part, out, B, T, Cin, Cout, d, nsplit)
    else:
        xp, gp = pad_channels(x) if padded is None else padded, pad_channels(g)
        DW_LIB("tap_conv_dw_bf16", x.device, xp, gp, part, out, B, T, Cin, Cout, xp.shape[2], gp.shape[2], d, nsplit)
    tap_conv_dw.launches += 1
    return out


def tap_conv_dw(x: torch.Tensor, g: torch.Tensor, dilation: int, padded=None) -> torch.Tensor:
    """(3, Cin, Cout) f32 weight gradients of the dilated k=3 conv whose input
    is x (B, T, Cin) and whose output cotangent is g (B, T, Cout).
    ``padded``: ``pad_channels(x)`` where the caller already holds it (the
    bf16 body reads it in place of making its own copy)."""
    if x.dim() != 3 or g.dim() != 3 or x.shape[:2] != g.shape[:2]:
        raise ValueError(f"tap_conv_dw shapes: x (B, T, Cin), g (B, T, Cout); got {tuple(x.shape)}, {tuple(g.shape)}")
    if int(dilation) != dilation or dilation < 1:
        raise ValueError(f"tap_conv_dw needs an integer dilation >= 1, got {dilation}")
    if padded is not None and (padded.shape[:2] != x.shape[:2] or padded.shape[2] != x.shape[2] + (-x.shape[2] % 8)
                               or padded.dtype != x.dtype or not padded.is_contiguous() or padded.data_ptr() % 16):
        raise ValueError(f"tap_conv_dw: padded must be pad_channels(x), got {tuple(padded.shape)} {padded.dtype}")
    if x.is_cuda:
        return _launch(x, g, int(dilation), padded)
    if x.device.type != "cpu":
        raise ValueError(f"tap_conv_dw runs on CUDA or CPU tensors, got {x.device}")
    return tap_conv_dw_plain(x, g, int(dilation))


tap_conv_dw.launches = 0  # kernel launches (CUDA tensors only)


def conv3(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """(B, T, Cin) x (3, Cin, Cout) dilated-by-d 'SAME' conv as 3 shifted
    matmuls, zero padding at the edges, f32 accumulation, f32 out."""
    T = x.shape[-2]
    xp = Fn.pad(x.float(), (0, 0, d, d))
    wf = w.float()
    y = None
    for j in range(3):
        yj = xp[:, j * d : j * d + T] @ wf[j]
        y = yj if y is None else y + yj
    return y


def tap_conv_plain(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Reference: the three shifted tap products summed in f32, one cast to
    x's dtype. x (B, T, Cin), w (3, Cin, Cout) -> (B, T, Cout)."""
    return conv3(x, w, dilation).to(x.dtype)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, d: int, transposed: bool) -> torch.Tensor:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"tap_conv takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if not (w.is_cuda and w.device == x.device):
        raise ValueError("tap_conv: x and w must lie on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tap_conv takes contiguous tensors")
    B, T, Cin = x.shape
    Cout = w.shape[1] if transposed else w.shape[2]
    y = torch.empty((B, T, Cout), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        LIB("tap_conv_f32", x.device, x, flip_taps(w) if transposed else w, y, B, T, Cin, Cout, d)
    else:
        xp = pad_channels(x)
        LIB("tap_conv_bf16", x.device, xp, pack_weights(w, transposed), y, B, T, xp.shape[2], Cout, d,
            _build.sms(x.device))
    tap_conv.launches += 1
    return y


def _conv(x: torch.Tensor, w: torch.Tensor, dilation: int, transposed: bool) -> torch.Tensor:
    cin = w.shape[2] if transposed else w.shape[1]
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != 3 or cin != x.shape[2]:
        want = "(3, Cout, Cin)" if transposed else "(3, Cin, Cout)"
        raise ValueError(f"tap_conv shapes: x (B, T, Cin), w {want}; got {tuple(x.shape)}, {tuple(w.shape)}")
    if int(dilation) != dilation or not 0 < dilation < x.shape[1]:
        raise ValueError(f"tap_conv needs an integer dilation in (0, T={x.shape[1]}), got {dilation}")
    if x.is_cuda:
        return _launch_conv(x, w, int(dilation), transposed)
    if x.device.type != "cpu":
        raise ValueError(f"tap_conv runs on CUDA or CPU tensors, got {x.device}")
    return tap_conv_plain(x, flip_taps(w) if transposed else w, int(dilation))


def tap_conv(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """(B, T, Cout) dilated k=3 'SAME' conv of x (B, T, Cin) with w (3, Cin,
    Cout) in x's dtype, f32 accumulation. Raises ValueError unless
    0 < dilation < T, the domain of the JAX kernel."""
    return _conv(x, w, dilation, False)


def tap_conv_transposed(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """``tap_conv(x, flip_taps(w), dilation)`` for x (B, T, Cout) and w (3,
    Cin, Cout): the dx of the conv with w, as ``PallasTapConv``'s backward
    takes it. On the card K5 reads ``w.flip(0)``, one copy of the weights."""
    return _conv(x, w, dilation, True)


tap_conv.launches = 0  # kernel launches (CUDA tensors only)


def flip_taps(w: torch.Tensor) -> torch.Tensor:
    """(3, Cin, Cout) -> (3, Cout, Cin): the tap-reversed, transposed weights
    whose 'SAME' conv with the same dilation is the transposed conv."""
    return w.flip(0).transpose(1, 2).contiguous()


class PallasTapConv(torch.autograd.Function):
    """The JAX ``pallas_tap_conv`` custom VJP (``tap_conv.py:191-212`` of the
    JAX package): forward K5; dx = K5 on ``flip_taps(W)``
    (``tap_conv_transposed``); dW = K2, cast to W's dtype."""

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
        dx = tap_conv_transposed(g, w, d) if ctx.needs_input_grad[0] else None
        dw = tap_conv_dw(x, g, d).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None
