"""The GLU at the end of the module path's ConvBlock, h = a · σ(b) with
[a | b] = Y split over the last dim, as one differentiable op.

Replaces no Pallas kernel: the JAX package leaves the module path's GLU,
``a * jax.nn.sigmoid(b)`` (``speech_decoding_tpu/models/brain_encoder.py:481``),
to XLA, and K6's GLU epilogue (``ops/conv_block_train.py``) is its fused
path's counterpart. It is bound by bytes (at the flagship, B·T = 92,160
rows, Y of 640 bf16 channels): autograd's chain over the two strided halves
of Y ran a sigmoid and a multiply forward, and two multiplies,
``sigmoid_backward`` and the cat of the half-gradients backward, ~19 tensors
of B·T·D2 traffic with the saved sigmoid, where the op needs 8: read Y and
write h forward, read g and Y and write dY backward. ``csrc/glu.cu`` makes
one pass each way, σ in f32 recomputed from Y in the backward (no saved
sigmoid), the two half-gradients written straight into one dY (no cat).
Two launches a forward and backward, no allocation or synchronisation
inside a call, so CUDA graphs capture them.

``glu`` launches the kernels on what ``takes`` accepts (bf16 CUDA (B, T,
2D) with D a multiple of 8) and raises on anything else, never falling
back; the caller routes (``ConvBlock`` runs ``glu_plain``, the reference's
``a * torch.sigmoid(b)`` with autograd's backward, where ``takes``
refuses). ``glu.launches`` counts the kernels launched, one a forward and
one a backward, as a profiler records them.

Numerics against the plain version in bf16: σ and the product in f32,
rounded to bf16 once, where the plain version rounds σ(b) to bf16 first;
the backward in f32 with one rounding of each half-gradient, where autograd
rounds at every op.
"""

from __future__ import annotations

import torch

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import INT, PTR

LIB = _build.Library("glu", {"glu_fwd": [PTR] * 2 + [INT] * 3, "glu_bwd": [PTR] * 3 + [INT] * 3})


def takes(y: torch.Tensor) -> bool:
    """Whether the kernels take ``y``: a (B, T, 2D) bf16 CUDA tensor with D
    a multiple of 8 (16-byte loads of 8 channels of each half)."""
    return y.is_cuda and y.dtype == torch.bfloat16 and y.dim() == 3 and y.shape[-1] > 0 and y.shape[-1] % 16 == 0


def glu_plain(y: torch.Tensor) -> torch.Tensor:
    """a · σ(b), [a | b] = y over the last dim, in y's dtype: the
    reference's formulation [ref: models.py:164]."""
    a, b = y.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class _Glu(torch.autograd.Function):
    """The kernels' forward and backward. Saves Y alone."""

    @staticmethod
    def forward(ctx, y):
        y = _build.aligned(y)
        B, T, D2 = y.shape
        h = torch.empty(B, T, D2 // 2, dtype=y.dtype, device=y.device)
        LIB("glu_fwd", y.device, y, h, B * T, D2 // 2, _build.sms(y.device))
        glu.launches += 1
        ctx.save_for_backward(y)
        return h

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        B, T, D2 = y.shape
        g = _build.aligned(g.to(y.dtype))
        dy = torch.empty_like(y)
        LIB("glu_bwd", y.device, g, y, dy, B * T, D2 // 2, _build.sms(y.device))
        glu.launches += 1
        return dy


def glu(y: torch.Tensor) -> torch.Tensor:
    """h = a · σ(b), [a | b] = y (B, T, 2D) over the last dim, differentiable
    in y, through the kernels; raises unless ``takes(y)``."""
    if not takes(y):
        raise ValueError(f"glu takes (B, T, 2D) bfloat16 CUDA tensors with D % 8 == 0, got {tuple(y.shape)} "
                         f"{y.dtype} on {y.device}")
    return _Glu.apply(y)


glu.launches = 0
