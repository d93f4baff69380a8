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
a fallback. JAX's donation has no counterpart here (the state is updated in
place).

On the card the module-path train step replays its forward, CLIP loss,
backward and metric reductions from a CUDA graph, JAX's ``jit`` in effect:
the eager step issues ~1,000 small launches, each costing the host far more
than the card. A step takes the graph when everything it needs is on the
card and the step is one the graph holds: CUDA tensors (ids on the host),
a ``drop_mask``, no ``group``, no ``fused_blocks``, no ``remat`` and a
plain Adam (``_graphable``). Graphs are keyed on the batch's shapes and
dtypes and the mask's (the ``signature``), and belong to one state (the
addresses of its parameters and buffers; another state drops them). The
first call of a signature runs eagerly, as every other step does: it warms
cuBLAS, the kernel libraries and Adam's state. The second captures the
graph and replays it, every later one replays it: the batch is copied into
static device buffers on the step's stream, the ids (checked on the host)
and a host mask from pinned copies, so no copy waits for the card. The
signatures' graphs share one memory pool. Backward writes gradients the
graph owns (set to None before the capture, never zeroed after); Adam stays
eager on them, its hooks fire every step. The kernels' launch counters see
the capture once and no replay (a replay launches nothing from the host);
``step.captures`` and ``step.replays`` count the graph's calls.

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

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from speech_decoding_tpu_torch.models.classifier import retrieval_accuracy_from_similarity
from speech_decoding_tpu_torch.models.fused_train import fused_train_forward
from speech_decoding_tpu_torch.models.loss import clip_loss
from speech_decoding_tpu_torch.ops.retrieval import retrieval_metrics_kernel
from speech_decoding_tpu_torch.ops.scaling import apply_scale_stats, gwilliams_collate
from speech_decoding_tpu_torch.ops.subject_conv import check_host_ids
from speech_decoding_tpu_torch.parallel.clip_sharded import accuracy_from_local_similarity, clip_loss_sharded
from speech_decoding_tpu_torch.parallel.collectives import all_reduce_grads
from speech_decoding_tpu_torch.parallel.mesh import DataGroup, Grid
from speech_decoding_tpu_torch.training.state import TrainState
from speech_decoding_tpu_torch.utils.profiling import (
    STEP,
    STEP_BACKWARD,
    STEP_FORWARD,
    STEP_GRAPH,
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


def _graphable(state: TrainState, batch: Batch, drop_mask: Optional[torch.Tensor], fused_blocks: bool = False,
               group: Optional[DataGroup] = None) -> bool:
    """Whether a step may run from a graph: no group (a grid's data axis
    included) and no fused blocks, the state on the card, every batch tensor
    there but the ids on the host, a drop mask on either, the encoder not
    under remat, a plain Adam. Reads only devices and types."""
    dev = state.device
    if fused_blocks or group is not None or dev.type != "cuda" or drop_mask is None:
        return False
    if getattr(state.encoder, "remat", False) or not hasattr(state.encoder, "num_subjects"):
        return False
    if type(state.optimizer) is not torch.optim.Adam:
        return False
    ids = batch.get("subject_idxs")
    if ids is None or ids.device.type != "cpu":
        return False
    if drop_mask.device.type != "cpu" and drop_mask.device != dev:
        return False
    return all(getattr(v, "device", None) == dev for k, v in batch.items() if k != "subject_idxs")


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """What a captured step reads of the state: parameters, buffers (the
    BatchNorm statistics) and the temperature."""
    return [*state.encoder.parameters(), *state.encoder.buffers(), state.clip.temp]


def _signature(batch: Batch, drop_mask: torch.Tensor) -> tuple:
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())),
            tuple(drop_mask.shape), drop_mask.dtype, drop_mask.device.type)


class _StepGraph:
    """One signature's step as a CUDA graph: static device buffers for the
    batch, the ids and the mask, the captured forward, loss, backward and
    (loss, top1, top10), and the gradients the graph writes."""

    def __init__(self, state: TrainState, batch: Batch, drop_mask: torch.Tensor):
        ids = batch["subject_idxs"]
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items() if k != "subject_idxs"}
        self.inputs["subject_idxs"] = torch.empty(ids.shape, dtype=torch.int32, device=state.device)
        self.mask = torch.empty(drop_mask.shape, dtype=drop_mask.dtype, device=state.device)
        self._num_subjects = int(state.encoder.num_subjects)
        self._params = [*state.encoder.parameters(), state.clip.temp]
        self._keep = [t.detach() for t in _state_tensors(state)]  # the addresses the graph reads stay allocated
        self.graph = self.out = self.grads = None

    def load(self, batch: Batch, drop_mask: torch.Tensor) -> None:
        """The step's inputs into the static buffers, on the current stream.
        Host tensors cross from pinned copies without a wait (the caching
        host allocator reuses a block only once the copy out of it has run);
        a copy from pageable memory would wait for every replay queued
        before it."""
        ids = batch["subject_idxs"]
        check_host_ids(ids.numpy(), self._num_subjects)
        for k, v in batch.items():
            if k != "subject_idxs":
                self.inputs[k].copy_(v)
        self.inputs["subject_idxs"].copy_(ids.to(torch.int32).pin_memory(), non_blocking=True)
        self.mask.copy_(drop_mask.pin_memory() if drop_mask.device.type == "cpu" else drop_mask,
                        non_blocking=True)

    def capture(self, state: TrainState, forward: Callable, pool) -> None:
        """Captures ``forward(batch, mask) -> (logits, loss)``, the backward
        into fresh gradients and the metrics, in the memory pool ``pool``
        (None: a new one)."""
        state.optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the Prefetcher's thread keeps issuing its gathers meanwhile
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            logits, loss = forward(self.inputs, self.mask)
            loss.backward()
            top1, top10 = retrieval_accuracy_from_similarity(logits.detach(), ks=(1, 10))
            self.out = torch.stack([loss.detach().float(), top1, top10])
        self.grads = [p.grad for p in self._params]

    def point_grads(self) -> None:
        """Each parameter's gradient is the graph's (an eager step or another
        signature's graph replaces them)."""
        for p, g in zip(self._params, self.grads):
            if p.grad is not g:
                p.grad = g

    def metrics(self) -> Metrics:
        """Fresh tensors of this replay's (loss, top1, top10): the static
        outputs are overwritten by the next one."""
        loss, top1, top10 = self.out.clone()
        return {"loss": loss, "top1": top1, "top10": top10}


def make_train_step(reduction: str = "mean", collate: Optional[Dict] = None, fused_blocks: bool = False,
                    group: Group = None) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``step(state, batch, generator=None, drop_mask=None) -> (state,
    metrics)``: one optimizer step, in place. Metrics are 0-dim tensors on
    the state's device (loss, top1, top10, and temp after the update), fresh
    ones every call. ``fused_blocks`` runs the ConvBlocks as K6 (same
    function); ``group`` makes it a data-parallel step over the ranks'
    blocks, a ``Grid`` a step on the grid (module docstring). On the card a
    module-path step replays a CUDA graph from the second call of its
    signature on (module docstring); ``step.captures`` and ``step.replays``
    count them."""
    group = _data_axis(group)
    graphs: Dict[tuple, Optional[_StepGraph]] = {}  # signature -> its graph (None: seen once)
    owner: List[Optional[tuple]] = [None]  # addresses of the state the graphs read
    # one memory pool for every signature's graph: a replay writes each pool
    # tensor it reads, and its outputs (gradients, metrics) are used on the
    # stream before any other graph replays, so one graph's replay may
    # overwrite another's dead memory
    pool: List = [None]

    def graph_for(state: TrainState, batch: Batch, drop_mask) -> Optional[_StepGraph]:
        """The step's graph, a new one to capture, or None (run eagerly)."""
        if not _graphable(state, batch, drop_mask, fused_blocks, group):
            return None
        addresses = tuple(t.data_ptr() for t in _state_tensors(state))
        if addresses != owner[0]:
            if graphs:
                torch.cuda.synchronize(state.device)  # no replay of a dropped graph is still queued
                graphs.clear()
                pool[0] = None
            owner[0] = addresses
        key = _signature(batch, drop_mask)
        if key not in graphs:
            graphs[key] = None
            return None
        if graphs[key] is None:
            graphs[key] = _StepGraph(state, batch, drop_mask)
        return graphs[key]

    def train_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                   drop_mask: Optional[torch.Tensor] = None):
        with annotate(STEP):
            graph = graph_for(state, batch, drop_mask)
            if graph is None:
                state.optimizer.zero_grad(set_to_none=True)
                with annotate(STEP_FORWARD):
                    logits, loss = _train_forward(state, batch, collate, reduction, generator, drop_mask,
                                                  fused_blocks, group)
                with annotate(STEP_BACKWARD):
                    loss.backward()
                    if group is not None:
                        all_reduce_grads([*state.encoder.parameters(), state.clip.temp], group)
            else:
                with annotate(STEP_GRAPH):
                    graph.load(batch, drop_mask)
                    if graph.graph is None:
                        graph.capture(state, lambda b, m: _train_forward(state, b, collate, reduction, None, m),
                                      pool[0])
                        pool[0] = pool[0] or graph.graph.pool()
                        train_step.captures += 1
                    graph.graph.replay()
                    train_step.replays += 1
                graph.point_grads()
            with annotate(STEP_OPTIMIZER):
                state.optimizer.step()
            state.step += 1
            if graph is None:
                metrics = _metrics(state, logits, loss, group)
            else:
                metrics = {**graph.metrics(), "temp": state.clip.temp.detach()[0].clone()}
        return state, metrics

    train_step.captures = 0  # graphs captured
    train_step.replays = 0  # steps run as a graph replay (the capturing call's included)
    return train_step


def make_train_step_scan(step: Callable[..., Tuple[TrainState, Metrics]]) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``steps(state, batches, generator=None, drop_masks=None)``: k calls
    of ``step`` (made by ``make_train_step``) over a stacked batch (leading
    axis k on every tensor; drop_masks (k, C)), as JAX runs them in one
    ``lax.scan``. Metrics get a leading k axis. Under a ``group`` each rank
    passes its (k, b, ...) block of the stacked global batch
    (``parallel.shard_batch(batches, group, axis=1)``). The Trainer passes
    its own single step, so both share one graph a signature."""

    def train_steps(state: TrainState, batches: Batch, generator: Optional[torch.Generator] = None,
                    drop_masks: Optional[torch.Tensor] = None):
        out = []
        for i in range(batches["X"].shape[0]):
            mask = None if drop_masks is None else drop_masks[i]
            state, m = step(state, {k: v[i] for k, v in batches.items()}, generator, mask)
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
