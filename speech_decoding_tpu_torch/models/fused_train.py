"""The train-mode encoder forward with the five ConvBlocks as K6.

Port of ``speech_decoding_tpu/models/fused_train.py``: the same function as
``BrainEncoder.forward(train=True)``, on the encoder's own parameters and
BatchNorm buffers (so ``models.params_bridge`` carries JAX weights across
unchanged). In order [ref: speech_decoding/models.py:169-196]:

  (B, C, T) -> transpose -> SubjectBlock (spatial attention with train-time
  spatial dropout, shared 1x1 conv, per-subject matmul through K1) -> five
  ``ops.conv_block_train.conv_block_train`` (K6) -> two 1x1 GELU heads ->
  transpose back,

plus the torch-style running-statistics update (momentum 0.1, unbiased
variance with n = B·T) written into each block's ``TorchBatchNorm`` buffers
in place, as the module path does. There is no sharded variant yet (JAX's
``fused_train_forward_sharded``).
"""

from __future__ import annotations

from typing import Optional

import torch

from speech_decoding_tpu_torch.models.brain_encoder import _gelu, spatial_dropout_mask
from speech_decoding_tpu_torch.ops.conv_block_train import conv_block_train


@torch.no_grad()
def _running_update(bn, mean: torch.Tensor, var_biased: torch.Tensor, n: int) -> None:
    m = bn.momentum
    bn.mean.mul_(1 - m).add_(m * mean)
    bn.var.mul_(1 - m).add_(m * (var_biased * (n / max(n - 1, 1))))


def fused_train_forward(encoder, X: torch.Tensor, subject_idxs: torch.Tensor,
                        drop_mask: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Z of ``encoder`` (a ``BrainEncoder``) in train mode, its BN running
    statistics updated in place. Spatial dropout takes ``drop_mask`` (C,) if
    given, else draws one from ``generator``, as the module path does."""
    if drop_mask is None:
        drop_mask = spatial_dropout_mask(generator, encoder.loc, encoder.d_drop)
    if not encoder.channels_last_io:
        X = X.transpose(-1, -2)
    h = encoder.subject_block(X.to(encoder.compute_dtype), subject_idxs, drop_mask)
    n = h.shape[0] * h.shape[1]
    for k, blk in enumerate(encoder.conv_blocks):
        bn0, bn1 = blk.batchnorm0, blk.batchnorm1
        h, (m0, v0, m1, v1) = conv_block_train(
            h, blk.conv0.kernel, blk.conv0.bias, bn0.scale, bn0.bias,
            blk.conv1.kernel, blk.conv1.bias, bn1.scale, bn1.bias,
            blk.conv2.kernel, blk.conv2.bias, k, bn0.eps,
        )
        _running_update(bn0, m0, v0, n)
        _running_update(bn1, m1, v1, n)
    h = _gelu(encoder.conv_final1(h))
    h = _gelu(encoder.conv_final2(h))
    return h if encoder.channels_last_io else h.transpose(-1, -2)
