"""Train-mode BatchNorm followed by GELU, h = GELU(BN(y + skip)), as one
differentiable op: the module path's ConvBlock runs it twice a block.

Replaces no Pallas kernel: the JAX package leaves the module path's
BatchNorm to XLA, and K6's epilogues (``ops/conv_block_train.py``) are its
fused path's counterpart. It is bound by bytes (at the flagship, B·T =
92,160 rows of 320 bf16 channels, 59 MB a tensor): PyTorch's eager
train-mode chain (``models.brain_encoder.TorchBatchNorm`` then GELU) ran
~50 elementwise and reduction launches a layer over ~65 such tensors of
traffic, where the op needs to read y and write h forward, and read dh and
y and write dy backward. ``csrc/batchnorm_gelu.cu`` makes two passes each
way, because the batch statistics are a global barrier: forward, per-block
sums of y and y² (forming y = a + skip on the way when there is a skip),
a fixed-order finalize (mean, variance, the running statistics), then the
normalisation and GELU; backward, per-block sums of du and du·x̂ (du = dh ·
GELU'(u) recomputed from y, not stored), a fixed-order finalize (the scale
and bias gradients), then dy. Six launches a layer, no float atomics, no
allocation or synchronisation inside a call, so CUDA graphs capture it.

``bn_gelu_train`` launches the kernels for CUDA tensors (bf16, C a
multiple of 8, at most 2048: ``takes``) and runs ``bn_gelu_train_plain``
(``TorchBatchNorm``'s train formulas, ``batch_moments``, ``move_running``
and ``normalize``, which the module calls too, then GELU, with autograd's
backward) for CPU tensors; on the card it launches or raises, never falls back.
``bn_gelu_train.launches`` counts the kernels launched, three a forward
and three a backward, as a profiler records them.

Numerics against the plain version in bf16: the statistics are the same f32
formulas summed in another order; the normalisation has its three
roundings and GELU its one, with erf from one exp (Abramowitz–Stegun
7.1.26, |err| ≤ 1.5e-7, as the JAX package's Pallas kernels build it,
where the plain version has ``torch.erf``); the backward runs in f32 (x̂,
u and GELU') and rounds dy to bf16 once, where autograd rounds at every op.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import DOUBLE, INT, PTR

LIB = _build.Library("batchnorm_gelu", {"bngelu_fwd": [PTR] * 10 + [INT] * 3 + [DOUBLE] * 2,
                                        "bngelu_bwd": [PTR] * 10 + [INT] * 3})
_MAX_BLOCKS = 8  # a row pass's blocks an SM, at most: csrc/batchnorm_gelu.cu MAX_BLOCKS
KERNELS = 3  # kernels a forward or a backward launches: a sum pass, its finalize, a row pass


def takes(y: torch.Tensor) -> bool:
    """Whether the kernels take ``y``: a (B, T, C) bf16 CUDA tensor with C
    a multiple of 8 (16-byte rows of 8 channels a thread) and at most 2048
    (a block holds a row's 8-channel groups)."""
    return y.is_cuda and y.dtype == torch.bfloat16 and y.dim() == 3 and y.shape[-1] % 8 == 0 and y.shape[-1] <= 2048


def batch_moments(x: torch.Tensor):
    """The f32 batch mean and biased variance E[x²] − mean² of x (B, T, C)
    over (B, T): ``TorchBatchNorm``'s train statistics with no group."""
    xf = x.float()
    m = xf.mean(dim=(0, 1))
    return m, (xf * xf).mean(dim=(0, 1)) - m * m


def move_running(mean: torch.Tensor, var: torch.Tensor, m: torch.Tensor, v: torch.Tensor, n: int,
                 momentum: float) -> None:
    """Moves the running ``mean`` and ``var`` in place by ``momentum``
    towards the batch mean ``m`` and the unbiased variance of ``v`` over n
    rows."""
    with torch.no_grad():
        mean.mul_(1 - momentum).add_(momentum * m)
        var.mul_(1 - momentum).add_(momentum * (v * (n / max(n - 1, 1))))


def normalize(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float, dt: torch.dtype) -> torch.Tensor:
    """(x − m) · inv + bias in ``dt``, inv = rsqrt(v + eps) · scale in f32,
    each operand cast to ``dt`` first: one rounding an op."""
    inv = torch.rsqrt(v + eps) * scale
    return (x.to(dt) - m.to(dt)) * inv.to(dt) + bias.to(dt)


def bn_gelu_train_plain(y, skip, scale, bias, mean, var, eps: float = 1e-5, momentum: float = 0.1,
                        update: bool = True) -> torch.Tensor:
    """GELU(BN(y + skip)) with ``TorchBatchNorm``'s train formulas (the
    functions above, which it calls too) in y's dtype, the running ``mean``
    and ``var`` moved unless ``update`` is False, then exact GELU."""
    if skip is not None:
        y = y + skip
    m, v = batch_moments(y)
    if update:
        move_running(mean, var, m, v, y.shape[0] * y.shape[1], momentum)
    return Fn.gelu(normalize(y, m, v, scale, bias, eps, y.dtype), approximate="none")


def _check_params(y: torch.Tensor, *params: torch.Tensor) -> None:
    C = y.shape[-1]
    for t in params:
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"bn_gelu_train: parameters and running statistics must be contiguous ({C},) "
                             f"float32 on {y.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _part(C: int, dev) -> torch.Tensor:
    """f32 scratch: the two per-channel sums of each block of a sum pass."""
    return torch.empty(_MAX_BLOCKS * _build.sms(dev) * 2 * C, dtype=torch.float32, device=dev)


class _BnGeluTrain(torch.autograd.Function):
    """The kernels' forward and backward. Saves y (the sum with the skip,
    as the first pass wrote it) and the (3, C) statistics [mean; inv0 ·
    scale; inv0]; the skip receives the same gradient as y."""

    @staticmethod
    def forward(ctx, a, skip, scale, bias, mean, var, eps, momentum, update):
        B, T, C = a.shape
        dev, rows = a.device, B * T
        a = _build.aligned(a)
        if skip is not None:
            if skip.shape != a.shape or skip.dtype != a.dtype or skip.device != dev:
                raise ValueError(f"bn_gelu_train: skip {tuple(skip.shape)} {skip.dtype} does not match "
                                 f"{tuple(a.shape)} {a.dtype}")
            skip = _build.aligned(skip)
        y = a if skip is None else torch.empty_like(a)
        h = torch.empty_like(a)
        st = torch.empty(3, C, dtype=torch.float32, device=dev)
        moved = (mean, var) if update else (None, None)
        LIB("bngelu_fwd", dev, a, skip, scale, bias, y, h, _part(C, dev), st, *moved, rows, C, _build.sms(dev), eps,
            momentum)
        bn_gelu_train.launches += KERNELS
        ctx.save_for_backward(y, st, scale, bias)
        ctx.has_skip = skip is not None
        return h

    @staticmethod
    def backward(ctx, dh):
        y, st, scale, bias = ctx.saved_tensors
        B, T, C = y.shape
        dev, rows = y.device, B * T
        dh = _build.aligned(dh.to(y.dtype))
        dy = torch.empty_like(y)
        dscale, dbias = torch.empty_like(scale), torch.empty_like(bias)
        cst = torch.empty(2, C, dtype=torch.float32, device=dev)
        LIB("bngelu_bwd", dev, dh, y, st, bias, scale, _part(C, dev), cst, dscale, dbias, dy, rows, C, _build.sms(dev))
        bn_gelu_train.launches += KERNELS
        return dy, dy if ctx.has_skip else None, dscale, dbias, None, None, None, None, None


def bn_gelu_train(y: torch.Tensor, skip: Optional[torch.Tensor], scale: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5, momentum: float = 0.1,
                  update: bool = True) -> torch.Tensor:
    """h = GELU(BN(y + skip)) in train mode, differentiable in y, skip,
    ``scale`` and ``bias``: y (B, T, C) and the optional skip alike, the
    parameters and the running ``mean`` and ``var`` (moved in place unless
    ``update`` is False, as in a remat recomputation) (C,) f32. On the card
    the kernels (``takes`` must hold), on the CPU ``bn_gelu_train_plain``."""
    if y.is_cuda:
        if not takes(y):
            raise ValueError(f"bn_gelu_train takes (B, T, C) bfloat16 with C % 8 == 0 and C <= 2048 on the card, "
                             f"got {tuple(y.shape)} {y.dtype}")
        _check_params(y, scale, bias, mean, var)
        return _BnGeluTrain.apply(y, skip, scale, bias, mean, var, float(eps), float(momentum), bool(update))
    if y.device.type != "cpu":
        raise ValueError(f"bn_gelu_train runs on CUDA or CPU tensors, got {y.device}")
    return bn_gelu_train_plain(y, skip, scale, bias, mean, var, eps, momentum, update)


bn_gelu_train.launches = 0
