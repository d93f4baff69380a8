"""The eval-mode ConvBlock (K4).

Port of ``speech_decoding_tpu/ops/pallas/conv_block.py``. The encoder's
hot stack is five blocks of [dilated conv k=3 (+skip) -> BN -> GELU ->
dilated conv (+skip) -> BN -> GELU -> dilated conv -> GLU]
[ref: speech_decoding/models.py:120-166]. In eval mode BatchNorm is a
per-channel affine folded from the running statistics, so the whole block is
local compute. The CUDA kernels (``csrc/conv_block.cu``) take one of two
routes, by dtype (``conv_block_fused.route`` records the last one):

  * ``"wgmma"`` (bf16, D2 % 8 == 0): three launches of K6's TMA-fed
    ``wgmma`` conv body (``csrc/conv_wg.cuh``), one a conv, each with an
    epilogue of K4's own (folded BN and GELU into h0 and h1, then the GLU
    into the output). x reaches conv0 with its channels zero-padded to a
    multiple of 8 (``tap_conv.pad_channels``: block 0's 270 become 272); h0
    and h1 are scratch of the call. A bf16 input outside the rule raises.
  * ``"f32"``: one launch on the CUDA cores, the intermediates in shared
    memory with a recomputed halo.

``prepare_fused_stack`` stages each block's weights once in the layout its
route reads (``stage_weight``): f32 (3, Cin, Cout) as the reference holds
them; bf16 the K-major images ``[j, n, ci]`` of the wgmma body, conv0's and
conv1's through ``tap_conv.pack_weights`` (the input depth zero-padded to a
multiple of 8, ``conv0_depth``), conv2's through
``glu_pack`` (each channel's value and gate side by side).
``conv_block_plain``, a step-by-step copy of the Pallas ``_block_kernel``
batched over rows, reads either layout (``plain_weight``), so the CPU and
the card's plain comparison take the same staged tuple.

``conv_block_fused`` launches the kernels for CUDA tensors and runs
``conv_block_plain`` for CPU tensors; it never falls back on the card. It
counts one launch a block, whatever the route. Used by the serving encode
(``inference.SpeechDecoder``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import INT, PTR
from speech_decoding_tpu_torch.ops.tap_conv import conv3, pack_weights, pad_channels

LIB = _build.Library("conv_block", {"conv_block_fused_f32": [PTR] * 10 + [INT] * 5,
                                    "conv_block_fused_wg": [PTR] * 12 + [INT] * 6})

Staged = Tuple[torch.Tensor, ...]  # (w0, b0, a0, w1, b1, a1, w2, b2)


def dilations(k: int) -> Tuple[int, int]:
    """(d0, d1) of ConvBlock k: 2^((2k) % 5) and 2^((2k+1) % 5); conv2 uses 2."""
    return 2 ** ((2 * k) % 5), 2 ** ((2 * k + 1) % 5)


def gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32 (the Pallas kernel builds erf from exp because
    Mosaic lacks it; torch.erf is exact)."""
    xf = x.float()
    return 0.5 * xf * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))


def plain_weight(w: torch.Tensor, cin: int, glu: bool = False) -> torch.Tensor:
    """A staged weight as the reference holds it, (3, Cin, Cout): an f32
    weight is itself; a bf16 one is read back from its K-major image (the
    depth padding dropped; with ``glu``, the interleaved value and gate
    columns split back into halves, one copy)."""
    if w.dtype != torch.bfloat16:
        return w
    wk = w[..., :cin]
    if glu:
        n = wk.shape[1]
        return wk.reshape(3, n // 2, 2, cin).permute(0, 3, 2, 1).reshape(3, cin, n)
    return wk.transpose(1, 2)


def conv_block_plain(x, w0, b0, a0, w1, b1, a1, w2, b2, k: int) -> torch.Tensor:
    """Reference for the kernels: the Pallas ``_block_kernel`` step by step.
    x (B, T, Cin) -> (B, T, D2) in x's dtype; the conv outputs, bias, skip and
    BN affine are f32, y0 and y1 are cast to x's dtype before the next conv.
    Weights as ``stage_weight`` lays them out for their dtype."""
    d0, d1 = dilations(k)
    dt = x.dtype
    D2 = b1.shape[0]
    w0, w1, w2 = plain_weight(w0, x.shape[-1]), plain_weight(w1, D2), plain_weight(w2, D2, glu=True)
    y = conv3(x, w0, d0) + b0
    if k > 0:
        y = y + x.float()
    y = gelu_exact_f32(y * a0[0] + a0[1]).to(dt)
    y1 = conv3(y, w1, d1) + b1 + y.float()
    y1 = gelu_exact_f32(y1 * a1[0] + a1[1]).to(dt)
    y2 = conv3(y1, w2, 2) + b2
    return (y2[..., :D2] * torch.sigmoid(y2[..., D2:])).to(dt)


def conv0_depth(cin: int, dtype: torch.dtype) -> int:
    """Input channels of the staged conv0 weight: the bf16 route reads x and
    its weight image through tensor maps of 16-byte rows, so there the depth
    is zero-padded to a multiple of 8 (270 -> 272)."""
    return cin + (-cin % 8) if dtype == torch.bfloat16 else cin


def glu_pack(w2: torch.Tensor) -> torch.Tensor:
    """w2 (3, Cin, 2C) [value | gate] as the GLU conv of K4's conv2 and of
    K6's F3 and B1 reads it: K-major (3, 2C, Cin8) with ``[j, 2c, ci] =
    w2[j, ci, c]`` and ``[j, 2c + 1, ci] = w2[j, ci, C + c]``, so a wgmma
    accumulator thread, which holds adjacent column pairs, holds both halves
    of its channels; the input channels zero-padded to a multiple of 8. One
    copy."""
    _, cin, c2 = w2.shape
    v = w2.reshape(3, cin, 2, c2 // 2).permute(0, 3, 2, 1)  # (3, C, 2, Cin)
    pad = -cin % 8
    return (Fn.pad(v, (0, pad)) if pad else v.contiguous()).view(3, c2, cin + pad)


def stage_weight(w: torch.Tensor, dtype: torch.dtype, glu: bool = False) -> torch.Tensor:
    """A (3, Cin, Cout) conv weight as the route of ``dtype`` reads it, in a
    buffer of its own (16-byte aligned). f32: (3, Cin, Cout). bf16: the
    K-major image (3, Cout, ``conv0_depth(Cin)``) of ``tap_conv.pack_weights``
    with ``[j, n, ci] = w[j, ci, n]``; with ``glu`` (conv2, Cout = 2·D2)
    ``glu_pack``'s, whose rows 2c and 2c + 1 are channel c's value and gate
    columns."""
    if dtype != torch.bfloat16:
        return torch.empty(w.shape, dtype=dtype, device=w.device).copy_(w)
    w = w.to(dtype)
    return glu_pack(w) if glu else pack_weights(w)


def _route(dtype: torch.dtype, D2: int) -> str:
    """The route rule: ``"wgmma"`` for bf16 with D2 % 8 == 0 (TMA's 16-byte
    rows of h0, h1 and the weight images), ``"f32"`` for f32. Any other
    input raises: nothing falls back."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"conv_block_fused takes float32 or bfloat16 x, got {dtype}")
    if D2 % 8:
        raise ValueError(f"the bf16 route needs D2 % 8 == 0 (16-byte rows of h0, h1 and the weights), got D2={D2}")
    return "wgmma"


def _launch(x, w0, b0, a0, w1, b1, a1, w2, b2, k: int) -> torch.Tensor:
    B, T, Cin = x.shape
    D2 = w1.shape[1]
    route = _route(x.dtype, D2)
    f32, dt = torch.float32, x.dtype
    if route == "wgmma":  # the K-major images of stage_weight
        s0, s1, s2 = (3, D2, conv0_depth(Cin, dt)), (3, D2, D2), (3, 2 * D2, D2)
    else:
        s0, s1, s2 = (3, Cin, D2), (3, D2, D2), (3, D2, 2 * D2)
    expect = [(w0, s0, dt), (b0, (D2,), f32), (a0, (2, D2), f32), (w1, s1, dt), (b1, (D2,), f32),
              (a1, (2, D2), f32), (w2, s2, dt), (b2, (2 * D2,), f32)]
    for i, (t, shape, dtype) in enumerate(expect):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"conv_block_fused argument {i + 1}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} (stage the weights with prepare_fused_stack)")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv_block_fused argument {i + 1} must be contiguous on {x.device}")
        if route == "wgmma" and t.dim() == 3 and t.data_ptr() % 16:
            # the weight images are read through tensor maps
            raise ValueError(f"conv_block_fused argument {i + 1} must start 16-byte aligned")
    if not x.is_contiguous():
        raise ValueError("conv_block_fused takes a contiguous x")
    if k > 0 and Cin != D2:
        raise ValueError(f"block k={k} has a skip around conv0, so Cin must equal D2 ({Cin} != {D2})")
    out = torch.empty((B, T, D2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if route == "wgmma":
        xp = pad_channels(x)  # 16-byte rows and base: block 0's 270 channels become 272
        h0, h1 = torch.empty_like(out), torch.empty_like(out)
        LIB("conv_block_fused_wg", x.device, xp, w0, b0, a0, w1, b1, a1, w2, b2, h0, h1, out, B, T, xp.shape[2], D2,
            k, _build.sms(x.device))
    else:
        if x.data_ptr() % 16:  # the x window is read with 16-byte loads where the width allows
            x = x.clone()
        LIB("conv_block_fused_f32", x.device, x, w0, b0, a0, w1, b1, a1, w2, b2, out, B, T, Cin, D2, k)
    conv_block_fused.route = route
    conv_block_fused.launches += 1
    return out


def conv_block_fused(x, w0, b0, a0, w1, b1, a1, w2, b2, k: int) -> torch.Tensor:
    """Eval-mode ConvBlock k: x (B, T, Cin) -> (B, T, D2). Weights in x's
    dtype as ``stage_weight`` lays them out for it (w2 with ``glu``);
    biases and the folded BN affines a0/a1 (2, D2) in f32."""
    if x.is_cuda:
        return _launch(x, w0, b0, a0, w1, b1, a1, w2, b2, k)
    if x.device.type != "cpu":
        raise ValueError(f"conv_block_fused runs on CUDA or CPU tensors, got {x.device}")
    return conv_block_plain(x, w0, b0, a0, w1, b1, a1, w2, b2, k)


conv_block_fused.launches = 0  # launches (CUDA tensors only): one a block, whatever the route
conv_block_fused.route = None  # the route of the last launch: "wgmma" or "f32"


def fold_bn(scale, bias, mean, var, eps: float = 1e-5) -> torch.Tensor:
    """(2, C) f32 [scale; offset] from eval-mode BN parameters and running stats."""
    s = scale.float() / torch.sqrt(var.float() + eps)
    return torch.stack([s, bias.float() - mean.float() * s])


def prepare_fused_stack(blocks: Sequence, dtype: torch.dtype) -> List[Staged]:
    """Fold the BN statistics and stage each block's weights once (weights in
    ``dtype`` through ``stage_weight``, biases and affines in f32, all
    contiguous on the blocks' device). ``blocks`` are the encoder's five
    ``ConvBlock`` modules."""
    staged = []
    with torch.no_grad():
        for blk in blocks:
            bn0, bn1 = blk.batchnorm0, blk.batchnorm1
            staged.append((
                stage_weight(blk.conv0.kernel, dtype), blk.conv0.bias.float().contiguous(),
                fold_bn(bn0.scale, bn0.bias, bn0.mean, bn0.var, bn0.eps).contiguous(),
                stage_weight(blk.conv1.kernel, dtype), blk.conv1.bias.float().contiguous(),
                fold_bn(bn1.scale, bn1.bias, bn1.mean, bn1.var, bn1.eps).contiguous(),
                stage_weight(blk.conv2.kernel, dtype, glu=True), blk.conv2.bias.float().contiguous(),
            ))
    return staged


def apply_fused_stack(staged: Sequence[Staged], x: torch.Tensor) -> torch.Tensor:
    """Apply all five fused ConvBlocks (eval mode) to x (B, T, D1)."""
    for k, args in enumerate(staged):
        x = conv_block_fused(x, *args, k=k)
    return x
