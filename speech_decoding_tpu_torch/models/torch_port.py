"""Import a reference PyTorch BrainEncoder checkpoint (numpy only).

A copy of ``speech_decoding_tpu/models/torch_port.py``: the port keeps its
own so that it never imports the JAX package.

The reference saves ``torch.save(brain_encoder.state_dict(), "model_last.pt")``
every epoch — encoder weights only [ref: train.py:259]. This module maps that
state_dict onto the flax-layout parameter tree (and BatchNorm running
statistics) that both packages share; ``models.params_bridge`` loads the
result into the port's ``BrainEncoder`` (the serve CLI's
``torch_checkpoint=`` path).

Layer mapping (the JAX package verifies it against the EXECUTED reference
modules in
tests/test_reference_golden.py::test_torch_checkpoint_import_matches_reference):

  subject_block.spatial_attention.z (complex)  -> z_re / z_im
  subject_block.conv.weight (D1, D1, 1)        -> conv.kernel (1, D1, D1)
  subject_block.subject_layer.{s}.weight       -> subject_kernel (S, D1, D1)
  conv_blocks.conv{k}.conv{0,1,2}.weight (o,i,w) -> conv{k}.conv{0,1,2}.kernel (w,i,o)
  conv_blocks.conv{k}.batchnorm{0,1}.{weight,bias} -> scale/bias
  conv_blocks.conv{k}.batchnorm{0,1}.running_{mean,var} -> batch_stats mean/var
  conv_final{1,2}.weight                       -> conv_final{1,2}.kernel

The spatial-attention cos/sin bases are NOT ported: both frameworks compute
them deterministically from the sensor layout [ref: models.py:36-40], so the
imported model must be constructed with the same layout the torch model was
trained with (position-exact `layout_2d.npz` for real-data checkpoints).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def infer_dims(sd: Dict) -> Dict[str, int]:
    """Architecture dims from state_dict shapes: S, D1, D2, F, K."""
    S = len([k for k in sd if k.startswith("subject_block.subject_layer.")])
    D1 = _np(sd["subject_block.conv.weight"]).shape[0]
    K2 = _np(sd["subject_block.spatial_attention.z"]).shape[-1]
    K = int(round(math.sqrt(K2)))
    assert K * K == K2, f"z has {K2} harmonics; not a square K*K grid"
    D2 = _np(sd["conv_blocks.conv0.batchnorm0.weight"]).shape[0]
    F = _np(sd["conv_final2.weight"]).shape[0]
    return {"S": S, "D1": D1, "D2": D2, "F": F, "K": K}


def brain_encoder_from_torch(sd: Dict) -> Tuple[Dict, Dict, Dict[str, int]]:
    """Reference BrainEncoder state_dict -> (params, batch_stats, dims) in
    our flax tree structure (numpy leaves, float32)."""
    dims = infer_dims(sd)
    S = dims["S"]

    z = _np(sd["subject_block.spatial_attention.z"])
    params: Dict = {
        "subject_block": {
            "spatial_attention": {
                "z_re": np.ascontiguousarray(z.real, np.float32),
                "z_im": np.ascontiguousarray(z.imag, np.float32),
            },
            "conv": {
                "kernel": _np(sd["subject_block.conv.weight"])[:, :, 0].T[None].astype(np.float32),
                "bias": _np(sd["subject_block.conv.bias"]).astype(np.float32),
            },
            "subject_kernel": np.stack(
                [
                    _np(sd[f"subject_block.subject_layer.{s}.weight"])[:, :, 0].T
                    for s in range(S)
                ]
            ).astype(np.float32),
        }
    }
    batch_stats: Dict = {}
    for k in range(5):
        blk: Dict = {}
        for conv in ("conv0", "conv1", "conv2"):
            w = _np(sd[f"conv_blocks.conv{k}.{conv}.weight"])
            blk[conv] = {
                "kernel": w.transpose(2, 1, 0).astype(np.float32),
                "bias": _np(sd[f"conv_blocks.conv{k}.{conv}.bias"]).astype(np.float32),
            }
        stats: Dict = {}
        for bn in ("batchnorm0", "batchnorm1"):
            blk[bn] = {
                "scale": _np(sd[f"conv_blocks.conv{k}.{bn}.weight"]).astype(np.float32),
                "bias": _np(sd[f"conv_blocks.conv{k}.{bn}.bias"]).astype(np.float32),
            }
            stats[bn] = {
                "mean": _np(sd[f"conv_blocks.conv{k}.{bn}.running_mean"]).astype(np.float32),
                "var": _np(sd[f"conv_blocks.conv{k}.{bn}.running_var"]).astype(np.float32),
            }
        params[f"conv{k}"] = blk
        batch_stats[f"conv{k}"] = stats
    for name in ("conv_final1", "conv_final2"):
        w = _np(sd[f"{name}.weight"])
        params[name] = {
            "kernel": w.transpose(2, 1, 0).astype(np.float32),
            "bias": _np(sd[f"{name}.bias"]).astype(np.float32),
        }
    return params, batch_stats, dims
