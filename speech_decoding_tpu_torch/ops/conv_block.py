"""A fully fused eval-mode ConvBlock.

Port of ``speech_decoding_tpu/ops/pallas/conv_block.py`` (K4). The encoder's
hot stack is five blocks of [dilated conv k=3 (+skip) -> BN -> GELU ->
dilated conv (+skip) -> BN -> GELU -> dilated conv -> GLU]
[ref: speech_decoding/models.py:120-166]. In eval mode BatchNorm is a
per-channel affine folded from the running statistics, so the whole block is
local compute; the CUDA kernel (``csrc/conv_block.cu``) runs it in one launch
per block, with the intermediates in shared memory (see the source for the
halo-recompute design), so the only device-memory traffic is the block's
input, its output and its weights. bf16 runs on the tensor cores (and needs
D2 % 16 == 0), f32 on the CUDA cores. ``prepare_fused_stack`` stages the
weights once in the layout the kernel reads (``stage_weight``).

``conv_block_fused`` launches the kernel for CUDA tensors and uses
``conv_block_plain`` — a step-by-step copy of the Pallas ``_block_kernel``,
batched over rows — for CPU tensors; it never falls back on the card.
Used by the serving encode (``inference.SpeechDecoder``).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from speech_decoding_tpu_torch.ops import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

Staged = Tuple[torch.Tensor, ...]  # (w0, b0, a0, w1, b1, a1, w2, b2)


def dilations(k: int) -> Tuple[int, int]:
    """(d0, d1) of ConvBlock k: 2^((2k) % 5) and 2^((2k+1) % 5); conv2 uses 2."""
    return 2 ** ((2 * k) % 5), 2 ** ((2 * k + 1) % 5)


def _gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32 (the Pallas kernel builds erf from exp because
    Mosaic lacks it; torch.erf is exact)."""
    xf = x.float()
    return 0.5 * xf * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))


def _conv3(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """(B, T, Cin) x (3, Cin, Cout) dilated-by-d 'SAME' conv as 3 shifted
    matmuls, zero padding at the edges, f32 accumulation."""
    T = x.shape[-2]
    xp = torch.nn.functional.pad(x.float(), (0, 0, d, d))
    wf = w.float()
    y = None
    for j in range(3):
        yj = xp[:, j * d : j * d + T] @ wf[j]
        y = yj if y is None else y + yj
    return y


def conv_block_plain(x, w0, b0, a0, w1, b1, a1, w2, b2, k: int) -> torch.Tensor:
    """Reference for the kernel: the Pallas ``_block_kernel`` step by step.
    x (B, T, Cin) -> (B, T, D2) in x's dtype; the conv outputs, bias, skip and
    BN affine are f32, y0 and y1 are cast to x's dtype before the next conv.
    Input channels of w0 beyond Cin (the zero depth padding of a staged bf16
    w0) are not read."""
    d0, d1 = dilations(k)
    dt = x.dtype
    y = _conv3(x, w0[:, : x.shape[-1]], d0) + b0
    if k > 0:
        y = y + x.float()
    y = _gelu_exact_f32(y * a0[0] + a0[1]).to(dt)
    y1 = _conv3(y, w1, d1) + b1 + y.float()
    y1 = _gelu_exact_f32(y1 * a1[0] + a1[1]).to(dt)
    y2 = _conv3(y1, w2, 2) + b2
    D2 = y2.shape[-1] // 2
    return (y2[..., :D2] * torch.sigmoid(y2[..., D2:])).to(dt)


def conv0_depth(cin: int, dtype: torch.dtype) -> int:
    """Input channels of the staged conv0 weight: the bf16 kernel works in
    16-channel fragments, so there the depth is zero-padded to a multiple of 16."""
    return cin + (-cin % 16) if dtype == torch.bfloat16 else cin


def stage_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (3, Cin, Cout) conv weight as the kernel reads it: cast to ``dtype``
    and zero-padded to ``conv0_depth`` input channels, in a buffer of its own
    (so 16-byte aligned for the kernel's vector copies)."""
    taps, cin, cout = w.shape
    out = torch.zeros((taps, conv0_depth(cin, dtype), cout), dtype=dtype, device=w.device)
    out[:, :cin] = w
    return out


def _launch(x, w0, b0, a0, w1, b1, a1, w2, b2, k: int) -> torch.Tensor:
    B, T, Cin = x.shape
    D2 = w1.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_block_fused takes float32 or bfloat16 x, got {x.dtype}")
    if x.dtype == torch.bfloat16 and D2 % 16:
        # the tensor-core path works in 16-channel fragments
        raise ValueError(f"the bf16 kernel needs D2 % 16 == 0, got D2={D2}")
    expect = [
        (w0, (3, conv0_depth(Cin, x.dtype), D2), x.dtype), (b0, (D2,), torch.float32), (a0, (2, D2), torch.float32),
        (w1, (3, D2, D2), x.dtype), (b1, (D2,), torch.float32), (a1, (2, D2), torch.float32),
        (w2, (3, D2, 2 * D2), x.dtype), (b2, (2 * D2,), torch.float32),
    ]
    for i, (t, shape, dtype) in enumerate(expect):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"conv_block_fused argument {i + 1}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} (stage the weights with prepare_fused_stack)")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv_block_fused argument {i + 1} must be contiguous on {x.device}")
        if x.dtype == torch.bfloat16 and t.dim() == 3 and t.data_ptr() % 16:
            # weights are copied in 16-byte pieces
            raise ValueError(f"conv_block_fused argument {i + 1} must start 16-byte aligned")
    if not x.is_contiguous():
        raise ValueError("conv_block_fused takes a contiguous x")
    if k > 0 and Cin != D2:
        raise ValueError(f"block k={k} has a skip around conv0, so Cin must equal D2 ({Cin} != {D2})")
    if x.data_ptr() % 16:  # the x window is read with 16-byte loads where the width allows
        x = x.clone()
    out = torch.empty((B, T, D2), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = getattr(_build.load("conv_block"), f"conv_block_fused_{_DTYPES[x.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), a0.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), a1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                 B, T, Cin, D2, k, stream)
    _build.check(err, f"conv_block_fused k={k}")
    conv_block_fused.launches += 1
    return out


def conv_block_fused(x, w0, b0, a0, w1, b1, a1, w2, b2, k: int) -> torch.Tensor:
    """Eval-mode ConvBlock k: x (B, T, Cin) -> (B, T, D2). Weights (3, Cin,
    D2), (3, D2, D2), (3, D2, 2·D2) in x's dtype, as ``stage_weight`` lays
    them out (in bf16, w0's depth padded to a multiple of 16); biases and the
    folded BN affines a0/a1 (2, D2) in f32."""
    if x.is_cuda:
        return _launch(x, w0, b0, a0, w1, b1, a1, w2, b2, k)
    if x.device.type != "cpu":
        raise ValueError(f"conv_block_fused runs on CUDA or CPU tensors, got {x.device}")
    return conv_block_plain(x, w0, b0, a0, w1, b1, a1, w2, b2, k)


conv_block_fused.launches = 0  # kernel launches (CUDA tensors only)


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
                stage_weight(blk.conv2.kernel, dtype), blk.conv2.bias.float().contiguous(),
            ))
    return staged


def apply_fused_stack(staged: Sequence[Staged], x: torch.Tensor) -> torch.Tensor:
    """Apply all five fused ConvBlocks (eval mode) to x (B, T, D1)."""
    for k, args in enumerate(staged):
        x = conv_block_fused(x, *args, k=k)
    return x
