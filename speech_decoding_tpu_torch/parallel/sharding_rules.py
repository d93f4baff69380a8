"""The "model" axis: which parameters split column-wise, and the encoder on
a grid.

Port of ``speech_decoding_tpu/parallel/sharding_rules.py``. JAX's
``param_shardings`` gives ``P(..., "model")`` to every parameter with ndim
>= 2, last dim >= ``min_dim`` and last dim divisible by the model-axis size
m, and replicates the rest; GSPMD then inserts the collectives. The port's
parameters have JAX's names and layouts (conv kernels (k, in, out),
``z_re``/``z_im`` (D1, K²), ``subject_kernel`` (S, D1, D1)), so the same
rule picks the same tensors: at the flagship (m=2, min_dim=64) every conv
kernel, the subject kernel and z, 21 of the train state's 60 leaves.

``partition_encoder`` keeps each split parameter's block (model rank j
holds columns [j·c, (j+1)·c) of the last dim) as the module's new
parameter and gives the owning module the grid's model group, whose
forward then runs column-parallel with explicit collectives
(``parallel.collectives``; ``models/brain_encoder.py`` says where each
goes). ``gather_encoder_params`` puts the whole tensors back together, so
``models.params_bridge`` and checkpoints see the one-process layout.
Weights cross over as they do in one process: load them into the whole
encoder, then partition it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from speech_decoding_tpu_torch.parallel.collectives import all_gather_stack
from speech_decoding_tpu_torch.parallel.mesh import MODEL_AXIS, Grid


def param_shardings(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], m: int,
                    min_dim: int = 64) -> Dict[str, Tuple]:
    """{name: partition spec} of JAX's rule for (name, shape) pairs over m
    model ranks: ``(None, ..., "model")`` for a tensor split along its last
    dim, ``()`` (replicated) otherwise."""
    def rule(shape):
        return m > 1 and len(shape) >= 2 and shape[-1] >= min_dim and shape[-1] % m == 0

    return {name: ((None,) * (len(shape) - 1) + (MODEL_AXIS,) if rule(shape) else ()) for name, shape in named_shapes}


def _owner(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    mod = root
    for part in path:
        mod = getattr(mod, part)
    return mod, leaf


@torch.no_grad()
def partition_encoder(encoder: nn.Module, grid: Grid, min_dim: int = 64) -> Dict[str, Tuple]:
    """Split ``encoder``'s parameters over ``grid.model`` in place by
    ``param_shardings``: each split parameter becomes this rank's column
    block (a new ``nn.Parameter``; build the optimizer after this call), and
    its module gets ``model_group``. The spatial attention's Fourier bases
    keep the rows of its z block (K² is the contraction dim there).
    Returns the specs. Makes no collective; raises ValueError on an encoder
    partitioned already."""
    if any(getattr(mod, "model_group", None) is not None for mod in encoder.modules()):
        raise ValueError("the encoder is partitioned already")
    m, j = grid.model.world, grid.model.rank
    specs = param_shardings(((n, tuple(p.shape)) for n, p in encoder.named_parameters()), m, min_dim)
    owners = set()
    for name, spec in specs.items():
        if spec:
            mod, leaf = _owner(encoder, name)
            p = getattr(mod, leaf)
            c = p.shape[-1] // m
            setattr(mod, leaf, nn.Parameter(p[..., j * c : (j + 1) * c].clone()))
            mod.model_group = grid.model
            owners.add(mod)
    for mod in owners:
        if hasattr(mod, "cos_b"):  # SpatialAttention: z's columns are the bases' rows
            c = mod.z_re.shape[-1]
            mod.cos_b, mod.sin_b = (b[j * c : (j + 1) * c].clone() for b in (mod.cos_b, mod.sin_b))
    return specs


@torch.no_grad()
def gather_split(encoder: nn.Module, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``named`` (parameter or state names of ``encoder``: its values, or
    their gradients) with every split tensor's blocks gathered over its
    module's model group, the rest as they are. Every model rank must call,
    with the same names in the same order. A module with a model group
    holds no other tensor of ndim >= 2, and none with a smaller one splits."""
    out = {}
    for name, t in named.items():
        group = getattr(_owner(encoder, name)[0], "model_group", None)
        out[name] = torch.cat(list(all_gather_stack(t, group)), dim=-1) if group is not None and t.ndim >= 2 else t
    return out


def gather_encoder_params(encoder: nn.Module) -> Dict[str, torch.Tensor]:
    """The encoder's whole ``state_dict``, in the one-process layout (every
    model rank must call)."""
    return gather_split(encoder, encoder.state_dict())
