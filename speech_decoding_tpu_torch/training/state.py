"""Train state: encoder (parameters and BN running statistics), the CLIP
temperature, and one Adam over both.

Port of ``speech_decoding_tpu/training/state.py``. The reference optimizes
``encoder.parameters() + loss.parameters()`` with one Adam
[ref: train.py:161-163]. Gradient accumulation (Brennan steps once per
epoch [ref: train.py:205-209]) behaves as optax.MultiSteps: the mean of k
gradients, applied every k-th call; ``MultiSteps.state_dict()`` carries that
cycle through a checkpoint.

JAX donates its state to each step and gets a new one back; the port
updates the modules and the optimizer in place, and a step returns the same
``TrainState`` object.

Data-parallel ranks each hold the whole state, which must be the same on
every rank: each builds its encoder from the shared seed, as each JAX host
initializes from the same key, and ``create_train_state(group=...)``
checks it against rank 0's (``state_digest``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import torch
from torch import nn

from speech_decoding_tpu_torch.models.loss import CLIPLoss
from speech_decoding_tpu_torch.parallel.collectives import assert_same_on_ranks, tensors_digest
from speech_decoding_tpu_torch.parallel.mesh import Grid
from speech_decoding_tpu_torch.utils.device import resolve_device


class MultiSteps:
    """optax.MultiSteps(every_k_schedule=k) around a torch optimizer: each
    ``step()`` folds the current gradients into a running mean
    (acc += (g − acc) / (n + 1), optax's update); every k-th call the inner
    optimizer steps on that mean and the mean restarts. In between the
    parameters and the inner state do not change."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = int(every_k)
        self.mini_step = 0
        self._params: List[torch.Tensor] = [p for g in optimizer.param_groups for p in g["params"]]
        self._acc = [torch.zeros_like(p) for p in self._params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict:
        """The inner optimizer's state, the running mean of the gradients
        and the position in the k-step cycle: a run resumed from it steps as
        an uninterrupted one."""
        return {"optimizer": self.optimizer.state_dict(), "acc": [a.clone() for a in self._acc],
                "mini_step": self.mini_step, "every_k": self.every_k}

    def load_state_dict(self, state: Dict) -> None:
        if int(state["every_k"]) != self.every_k or len(state["acc"]) != len(self._acc):
            raise ValueError(f"MultiSteps state for every_k={state['every_k']} over {len(state['acc'])} tensors "
                             f"does not fit every_k={self.every_k} over {len(self._acc)}")
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            for acc, saved in zip(self._acc, state["acc"]):
                acc.copy_(saved)
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for acc, p in zip(self._acc, self._params):
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((grad - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return
        for acc, p in zip(self._acc, self._params):
            p.grad = acc.clone()
        self.optimizer.step()
        for acc in self._acc:
            acc.zero_()
        self.mini_step = 0


def make_optimizer(params, lr: float, accumulate_steps: int = 1):
    """Adam with torch-default hyperparameters (b1=0.9, b2=0.999, eps=1e-8)
    [ref: train.py:161]; its update equals optax.adam's. ``accumulate_steps
    > 1`` wraps it in ``MultiSteps``."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return MultiSteps(opt, accumulate_steps) if accumulate_steps > 1 else opt


@dataclass
class TrainState:
    """step: optimizer calls so far (mini-steps included, as JAX counts);
    encoder: the BrainEncoder (its buffers are the BN running statistics);
    clip: the CLIPLoss holding the temperature; optimizer: Adam over
    ``encoder.parameters()`` and ``clip.temp`` (or MultiSteps around it)."""

    step: int
    encoder: nn.Module
    clip: CLIPLoss
    optimizer: Union[torch.optim.Optimizer, MultiSteps]

    @property
    def device(self) -> torch.device:
        return self.clip.temp.device


def _tensors(obj):
    """Every tensor of a (nested) optimizer state, in a fixed order."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _tensors(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def state_digest(state: TrainState) -> bytes:
    """sha256 of the whole state's bytes: parameters, BN running statistics,
    temperature, the optimizer's tensors (Adam's moments and step counts,
    MultiSteps' accumulated gradients) and the step. Equal digests on every
    rank mean bit-identical replicas."""
    return tensors_digest([*state.encoder.state_dict().values(), state.clip.temp,
                           *_tensors(state.optimizer.state_dict()), torch.tensor(state.step)])


def create_train_state(encoder: nn.Module, init_temperature: float = 5.1, lr: float = 3e-4,
                       accumulate_steps: int = 1,
                       device: Optional[Union[str, torch.device]] = None, group=None) -> TrainState:
    """Move ``encoder`` to ``device`` (default ``cuda``, or the group's
    device; raises without a GPU unless ``device="cpu"``), add the CLIP
    temperature and build the optimizer over both. The encoder's weights are
    its own initialization (seeded by the generator it was built with).
    ``group`` (a ``parallel.DataGroup``): raises on every rank unless every
    rank built the same state as rank 0. On a ``parallel.Grid`` (the encoder
    partitioned first, so the optimizer holds the blocks) the ranks of each
    data group, which hold the same blocks, are compared."""
    if isinstance(group, Grid):
        group = group.data
    dev = resolve_device(group.device if device is None and group is not None else device)
    encoder = encoder.to(dev)
    clip = CLIPLoss(init_temperature).to(dev)
    opt = make_optimizer([*encoder.parameters(), clip.temp], lr, accumulate_steps)
    state = TrainState(step=0, encoder=encoder, clip=clip, optimizer=opt)
    if group is not None:
        assert_same_on_ranks(state_digest(state), group, "the initial train state")
    return state
