"""Weights across the two packages: flax ``params`` / ``batch_stats`` trees
<-> the port's ``BrainEncoder`` state.

The port's modules carry the flax names and layouts (conv kernels stay
(k, in, out), ``subject_kernel`` (S, D1_in, D1_out), z split into
``z_re``/``z_im``), so the bridge is a flatten with "." joins and nothing is
transposed: ``params["conv0"]["conv1"]["kernel"]`` is the port's
``conv0.conv1.kernel``, ``batch_stats["conv2"]["batchnorm0"]["mean"]`` its
``conv2.batchnorm0.mean`` buffer. The trees are nested dicts of numpy
arrays (``jax.tree.map(np.asarray, ...)`` of the flax variables, or
``models.torch_port.brain_encoder_from_torch`` output).

A whole JAX ``TrainState.params`` is ``{"encoder": ..., "clip": {"temp":
(1,)}}``: ``load_flax_train`` / ``flax_train_from_state`` carry the CLIP
temperature beside the encoder.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.asarray(value, np.float32)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def load_flax(encoder: torch.nn.Module, params: Mapping, batch_stats: Mapping) -> torch.nn.Module:
    """Load flax trees into ``encoder`` in place (strict: every parameter and
    running statistic must be present with its shape). Returns ``encoder``."""
    flat = {**_flatten(params), **_flatten(batch_stats)}
    # torch.tensor copies: the leaves may be read-only views of device arrays
    encoder.load_state_dict({k: torch.tensor(v) for k, v in flat.items()}, strict=True)
    return encoder


def flax_from_state(encoder: torch.nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) flax trees with numpy f32 leaves from ``encoder``."""
    buffers = {name for name, _ in encoder.named_buffers()}
    params, stats = {}, {}
    for name, t in encoder.state_dict().items():
        (stats if name in buffers else params)[name] = t.detach().cpu().float().numpy()
    return _unflatten(params), _unflatten(stats)


def load_flax_train(encoder: torch.nn.Module, clip: torch.nn.Module, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Load a JAX ``TrainState``'s params (encoder and CLIP temperature) and
    batch_stats into ``encoder`` and ``clip`` (a ``CLIPLoss``) in place."""
    load_flax(encoder, params["encoder"], batch_stats)
    temp = np.asarray(params["clip"]["temp"], np.float32)
    if temp.shape != tuple(clip.temp.shape):
        raise ValueError(f"clip temperature must have shape {tuple(clip.temp.shape)}, got {temp.shape}")
    with torch.no_grad():
        clip.temp.copy_(torch.tensor(temp))


def flax_train_from_state(encoder: torch.nn.Module, clip: torch.nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) in the layout of a JAX ``TrainState``."""
    params, stats = flax_from_state(encoder)
    return {"encoder": params, "clip": {"temp": clip.temp.detach().cpu().float().numpy()}}, stats
