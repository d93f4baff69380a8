"""Train and eval steps.

Port of ``speech_decoding_tpu/training/steps.py``. One train step: the
optional Gwilliams collate (baseline + robust scale + clamp
[ref: gwilliams2022.py:653-661], or its precomputed-stats form), the encoder
forward in train mode (batch-stat BN, spatial dropout), the CLIP loss called
as loss(Y, Z) [ref: train.py:189-203], backward, Adam, and top-1/top-10 from
the detached loss logits [ref: train.py:194].

Batches are dicts: X (B, C, T) — or (B, T, C) for a channels-last encoder —,
Y (B, F, T) (or (B, T, F)), subject_idxs (B,), and scale_stats (B, C, 2)
for the precomputed collate. X, Y and scale_stats lie on the state's device.
subject_idxs may stay on the host: they are checked there and copied over
with the first launch, so a step does not wait for the card.

Spatial dropout draws its centre from the ``generator`` the caller passes
(a CPU ``torch.Generator``), or takes an explicit ``drop_mask`` (C,); JAX's
``fold_in(base_key, step)`` stream cannot be reproduced in torch. Eval
ranks through ``ops.retrieval.retrieval_metrics_kernel``: the K3 kernel on
the card, its plain version on the CPU. JAX's ``use_pallas_retrieval`` flag
is not carried over: a flag that sent CUDA tensors past the kernel would be
a fallback. Every step runs eagerly; JAX's ``jit`` and donation have no
counterpart here (the state is updated in place).

``fused_blocks=True`` (JAX's ``tpu.fused_train_blocks``) runs the train
forward through ``models.fused_train.fused_train_forward``: the five
ConvBlocks as K6 on the card, their plain versions on the CPU.

``group`` (a ``parallel.DataGroup``; JAX's mesh, and ``fused_mesh`` for the
fused path) makes a step one step on the global batch of W·b rows, each
rank passing its own b rows: synchronized BatchNorm on either path, the
global CLIP loss (``parallel.clip_sharded``: its value whole on every rank,
each rank's backward its share), top-1/top-10 of the global batch from the
rank's rows of the logits, and one all-reduce (SUM) of every gradient, the
temperature's included, before Adam. Every rank then holds the same
parameters, statistics and Adam moments. The drop mask must be passed and
be the same on every rank (the Trainer draws it from (seed, step)). The
eval steps take no group: every rank evaluates the whole test batch, as
JAX's multi-process eval does.

A ``parallel.Grid`` (``make_grid``; the encoder split by
``parallel.sharding_rules.partition_encoder``) is one step on the grid: the
loss, the top-k and the gradient all-reduce run on its data axis, the
encoder's split layers make their own model-axis collectives, and Adam
updates each rank's blocks (elementwise, so it equals Adam on the whole
parameters). A replicated parameter's graph runs after the gathers, so its
gradient is the same on every model rank and needs no model-axis sum. The
eval steps need no group on a grid either: every rank evaluates the whole
test batch, and the encoder's split layers make their model-axis
collectives (every rank of the grid calls the eval).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from speech_decoding_tpu_torch.models.classifier import retrieval_accuracy_from_similarity
from speech_decoding_tpu_torch.models.fused_train import fused_train_forward
from speech_decoding_tpu_torch.models.loss import clip_loss
from speech_decoding_tpu_torch.ops.retrieval import retrieval_metrics_kernel
from speech_decoding_tpu_torch.ops.scaling import apply_scale_stats, gwilliams_collate
from speech_decoding_tpu_torch.parallel.clip_sharded import accuracy_from_local_similarity, clip_loss_sharded
from speech_decoding_tpu_torch.parallel.collectives import all_reduce_grads
from speech_decoding_tpu_torch.parallel.mesh import DataGroup, Grid
from speech_decoding_tpu_torch.training.state import TrainState
from speech_decoding_tpu_torch.utils.profiling import (
    STEP,
    STEP_BACKWARD,
    STEP_FORWARD,
    STEP_OPTIMIZER,
    annotate,
)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
Group = Optional[Union[DataGroup, Grid]]


def _data_axis(group: Group) -> Optional[DataGroup]:
    return group.data if isinstance(group, Grid) else group


def _maybe_collate(batch: Batch, collate: Optional[Dict]) -> torch.Tensor:
    X = batch["X"]
    if collate is None:
        return X
    if collate.get("precomputed") and "scale_stats" in batch:
        return apply_scale_stats(X, batch["scale_stats"], collate["clamp_lim"], collate["clamp"],
                                 channels_last=bool(collate.get("channels_last", False)))
    return gwilliams_collate(X, baseline_len_samp=collate["baseline_len_samp"],
                             clamp_lim=collate["clamp_lim"], do_clamp=collate["clamp"])


def _train_forward(state: TrainState, batch: Batch, collate, reduction, generator, drop_mask, fused_blocks=False,
                   group: Optional[DataGroup] = None):
    if group is not None and drop_mask is None:
        raise ValueError("a data-parallel step takes the drop_mask: every rank must drop the same sensors")
    X = _maybe_collate(batch, collate)
    if fused_blocks:
        Z = fused_train_forward(state.encoder, X, batch["subject_idxs"], drop_mask, generator, group)
    else:
        Z = state.encoder(X, batch["subject_idxs"], train=True, drop_mask=drop_mask, generator=generator,
                          group=group)
    if group is None:
        return clip_loss(batch["Y"], Z, state.clip.temp[0], reduction, return_logits=True)
    return clip_loss_sharded(batch["Y"], Z, state.clip.temp[0], group, reduction, return_logits=True)


def _metrics(state: TrainState, logits: torch.Tensor, loss: torch.Tensor, group: Optional[DataGroup] = None
             ) -> Metrics:
    # logits[i, j] = Ŷ_i·Ẑ_j·e^temp: the cosine similarity in the reference's
    # orientation up to a positive factor, so diagonal ranks need no second
    # pass; under a group, the rank's rows of the global batch's logits
    if group is None:
        top1, top10 = retrieval_accuracy_from_similarity(logits.detach(), ks=(1, 10))
    else:
        top1, top10 = accuracy_from_local_similarity(logits.detach(), group, ks=(1, 10))
    return {"loss": loss.detach(), "top1": top1, "top10": top10,
            "temp": state.clip.temp.detach()[0].clone()}


def make_train_step(reduction: str = "mean", collate: Optional[Dict] = None, fused_blocks: bool = False,
                    group: Group = None) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``step(state, batch, generator=None, drop_mask=None) -> (state,
    metrics)``: one optimizer step, in place. Metrics are 0-dim tensors on
    the state's device (loss, top1, top10, and temp after the update).
    ``fused_blocks`` runs the ConvBlocks as K6 (same function); ``group``
    makes it a data-parallel step over the ranks' blocks, a ``Grid`` a step
    on the grid (module docstring)."""
    group = _data_axis(group)

    def train_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                   drop_mask: Optional[torch.Tensor] = None):
        with annotate(STEP):
            state.optimizer.zero_grad(set_to_none=True)
            with annotate(STEP_FORWARD):
                logits, loss = _train_forward(state, batch, collate, reduction, generator, drop_mask, fused_blocks,
                                              group)
            with annotate(STEP_BACKWARD):
                loss.backward()
                if group is not None:
                    all_reduce_grads([*state.encoder.parameters(), state.clip.temp], group)
            with annotate(STEP_OPTIMIZER):
                state.optimizer.step()
            state.step += 1
            metrics = _metrics(state, logits, loss, group)
        return state, metrics

    return train_step


def make_train_step_scan(reduction: str = "mean", collate: Optional[Dict] = None, fused_blocks: bool = False,
                         group: Group = None) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``steps(state, batches, generator=None, drop_masks=None)``: k train
    steps over a stacked batch (leading axis k on every tensor; drop_masks
    (k, C)), the same as k calls of the single step (JAX runs them in one
    ``lax.scan``). Metrics get a leading k axis. Under a ``group`` each rank
    passes its (k, b, ...) block of the stacked global batch
    (``parallel.shard_batch(batches, group, axis=1)``)."""
    single = make_train_step(reduction, collate, fused_blocks, group)

    def train_steps(state: TrainState, batches: Batch, generator: Optional[torch.Generator] = None,
                    drop_masks: Optional[torch.Tensor] = None):
        out = []
        for i in range(batches["X"].shape[0]):
            mask = None if drop_masks is None else drop_masks[i]
            state, m = single(state, {k: v[i] for k, v in batches.items()}, generator, mask)
            out.append(m)
        return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return train_steps


def make_train_forward_step(reduction: str = "mean", collate: Optional[Dict] = None,
                            group: Group = None) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Train-mode forward without a parameter update: batch-stat BN with the
    running statistics updated, spatial dropout, metrics — what the
    reference's non-final Brennan batches effectively do
    [ref: train.py:205-209]. ``group`` as in ``make_train_step``."""
    group = _data_axis(group)

    def forward_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                     drop_mask: Optional[torch.Tensor] = None):
        with torch.no_grad():
            logits, loss = _train_forward(state, batch, collate, reduction, generator, drop_mask, group=group)
        return state, _metrics(state, logits, loss, group)

    return forward_step


def _score(Z: torch.Tensor, Y: torch.Tensor, temp: torch.Tensor, reduction: str) -> Metrics:
    loss = clip_loss(Y, Z, temp, reduction)
    top1, top10 = retrieval_metrics_kernel(Z, Y, ks=(1, 10))
    return {"loss": loss, "top1": top1, "top10": top10}


def make_eval_step(reduction: str = "mean", collate: Optional[Dict] = None
                   ) -> Callable[[TrainState, Batch], Metrics]:
    """Full-batch eval: forward with running BN statistics and no dropout,
    loss, retrieval ranks [ref: train.py:211-233]."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        X = _maybe_collate(batch, collate)
        Z = state.encoder(X, batch["subject_idxs"], train=False)
        return _score(Z, batch["Y"], state.clip.temp[0], reduction)

    return eval_step


def make_chunked_eval(reduction: str = "mean", collate: Optional[Dict] = None, chunk_size: int = 256
                      ) -> Callable[[TrainState, Batch], Metrics]:
    """Full-test-set eval with bounded memory: the forward runs in chunks of
    ``chunk_size`` segments (the tail chunk padded by repeating its last row,
    so every forward has one shape), the embeddings are kept in the compute
    dtype, then one loss and retrieval pass over all of them. Equals
    ``make_eval_step`` up to the embedding-storage dtype."""

    @torch.no_grad()
    def evaluate(state: TrainState, batch: Batch) -> Metrics:
        B = batch["X"].shape[0]
        inputs = {k: v for k, v in batch.items() if k != "Y"}
        chunks = []
        for start in range(0, B, chunk_size):
            n = min(chunk_size, B - start)
            sub = {k: v[start : start + n] for k, v in inputs.items()}
            if n < chunk_size:
                sub = {k: torch.cat([v, v[-1:].expand(chunk_size - n, *v.shape[1:])]) for k, v in sub.items()}
            X = _maybe_collate(sub, collate)
            chunks.append(state.encoder(X, sub["subject_idxs"], train=False)[:n])
        return _score(torch.cat(chunks), batch["Y"], state.clip.temp[0], reduction)

    return evaluate
