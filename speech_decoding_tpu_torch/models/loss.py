"""CLIP-style contrastive loss with a learned temperature.

Port of ``speech_decoding_tpu/models/loss.py`` (the reference's
speech_decoding/utils/loss.py:16-84): plain functions plus ``CLIPLoss``, the
module that holds the temperature so one optimizer trains it with the
encoder [ref: train.py:161-163].
"""

from __future__ import annotations

import torch
from torch import nn


def clamped_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with input clamped to <= 10 [ref: loss.py:8-9]."""
    return torch.exp(torch.clamp(x, max=10.0))


def clamped_log(x: torch.Tensor) -> torch.Tensor:
    """log with input clamped to >= 1e-10 [ref: loss.py:12-13]."""
    return torch.log(torch.clamp(x, min=1e-10))


def mse_loss(Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """MSE summed over (feature, time), averaged over batch [ref: loss.py:24-25]."""
    return torch.mean(torch.sum(torch.square(Y - Z), dim=(-1, -2)))


def _cross_entropy_arange(logits: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Cross-entropy against targets arange(B) (the CLIP diagonal)."""
    nll = -torch.diagonal(torch.log_softmax(logits, dim=-1))
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def clip_logits(x: torch.Tensor, y: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Flatten, L2-normalize and correlate: logits = x̂ @ ŷᵀ · exp(temp)
    [ref: loss.py:61-71]. x, y: (B, F, T) or (B, D).

    Each input is normalized in its own dtype with an f32 sum of squares, as
    the JAX function does. The product is f32: JAX promotes a mixed f32/bf16
    pair (the flagship step's f32 Y and bf16 Z) to f32, where torch.matmul
    would raise on the mix, and it accumulates a bf16 pair in f32, which the
    f32 product of the upcast (exact) values equals."""
    B = x.shape[0]
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x = x / torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32)[:, None].to(x.dtype)
    y = y / torch.linalg.vector_norm(y, dim=-1, dtype=torch.float32)[:, None].to(y.dtype)
    logits = x.float() @ y.float().T
    return logits * torch.exp(temp)


def clip_loss(x: torch.Tensor, y: torch.Tensor, temp: torch.Tensor, reduction: str = "mean",
              return_logits: bool = False):
    """Symmetric InfoNCE: (CE(logits) + CE(logitsᵀ)) / 2 against arange
    targets [ref: loss.py:79]. Called as clip_loss(Y, Z): x = audio, y = brain
    embeddings [ref: train.py:191]."""
    if x.shape[0] <= 1:
        raise ValueError("Batch size must be greater than 1.")  # [ref: loss.py:40]
    logits = clip_logits(x, y, temp)
    loss = (_cross_entropy_arange(logits, reduction) + _cross_entropy_arange(logits.T, reduction)) / 2
    if return_logits:
        return logits, loss
    return loss


class CLIPLoss(nn.Module):
    """Holds the learned temperature ``temp`` (shape (1,), init 5.1)
    [ref: loss.py:36]."""

    def __init__(self, init_temperature: float = 5.1, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction
        self.temp = nn.Parameter(torch.full((1,), float(init_temperature)))

    def forward(self, x: torch.Tensor, y: torch.Tensor, return_logits: bool = False):
        return clip_loss(x, y, self.temp[0], self.reduction, return_logits)
