"""The collectives of the data-parallel and model-parallel step, on a
``DataGroup`` or ``ModelGroup`` (each call on the group's process group).

No single JAX counterpart: JAX writes ``psum``, ``pmax`` and ``all_gather``
inside ``shard_map`` (``parallel/clip_sharded.py``,
``ops/pallas/conv_block_train.py``) and lets GSPMD insert the rest, and its
transpose rules give each collective its backward. Here each is one
``torch.distributed`` call on the group's device, and the two that sit on
the differentiated path are ``torch.autograd.Function``s whose backward is
the collective's transpose:

  * ``all_reduce_sum``: y = Σ_ranks x; its backward sums the cotangents of
    every rank's copy of y (another all-reduce);
  * ``all_gather_rows``: y = concat of every rank's x (B = W·b rows); its
    backward all-reduces the (B, ...) cotangent and takes the rank's b rows
    (gloo has no reduce-scatter; the all-reduce runs on both backends).

A step built on them gives each rank its share of the gradient of the
global loss; ``all_reduce_grads`` then sums the shares, in one all-reduce
of every gradient flattened.

On the "model" axis (``parallel.sharding_rules``: column-parallel layers,
JAX's ``P(..., "model")`` parameters, whose collectives GSPMD inserts) three
more, each backward the transpose given that every model rank runs the
identical downstream graph on the identical rows (Megatron's regions):

  * ``copy_to_model``: identity; backward all-reduces over the model
    group, since a column-parallel layer's input gradient is the sum over
    its column blocks;
  * ``gather_from_model``: the ranks' blocks concatenated along the last
    (channel) dim in model-rank order; backward this rank's own block of
    the cotangent (``all_gather_rows``' backward, which all-reduces, would
    multiply every gradient by m here);
  * ``reduce_from_model``: an all-reduce; backward the cotangent unchanged
    (``sum_to_all`` on the model group).

Every rank of a group must call every collective in the same order, as the
identical step on every rank does. ``calls`` counts the collectives this
process has made, by axis and kind ("data.all_reduce", "model.all_gather",
...).
"""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import Iterable, List

import torch
import torch.distributed as dist

from speech_decoding_tpu_torch.parallel.mesh import DataGroup

calls: Counter = Counter()  # collectives made by this process, "<axis>.<kind>": all_reduce, all_gather, broadcast


def all_reduce_(t: torch.Tensor, group: DataGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over the group's ranks; ``t`` lies on the group's device.
    Returns ``t``."""
    calls[f"{group.axis}.all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group.pg)
    return t


def _all_gather(x: torch.Tensor, group: DataGroup) -> List[torch.Tensor]:
    calls[f"{group.axis}.all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x.contiguous(), group=group.pg)
    return parts


def all_gather_stack(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (W, ...). Not
    differentiable; every rank passes the same shape and dtype."""
    return torch.stack(_all_gather(x, group))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Σ over the ranks of ``x``, differentiable (the backward sums the
    cotangents over the ranks)."""
    return _AllReduceSum.apply(x, group)


class _KeptAllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, total, group):
        ctx.group = group
        return total.clone()

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None, None


def kept_all_reduce_sum(x: torch.Tensor, total: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """``all_reduce_sum(x, group)`` whose value ``total`` is already known
    (an earlier call on the same ``x``): a copy of ``total``, made with no
    collective, as a function of ``x``, so the ops after it record and save
    what they did after ``all_reduce_sum``. A rematerialized block's
    recomputation takes its BatchNorm sums so. The backward is
    ``all_reduce_sum``'s; non-reentrant ``torch.utils.checkpoint``
    differentiates the forward pass's graph (the recomputation only refills
    its saved tensors), so inside a recomputation it is not reached."""
    return _KeptAllReduceSum.apply(x, total, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_stack(x, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        r, b = ctx.group.rank, ctx.rows
        return g[r * b : (r + 1) * b], None


def all_gather_rows(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Every rank's ``x`` (b, ...) stacked in rank order: (W·b, ...),
    differentiable. Every rank passes the same shape."""
    return _AllGatherRows.apply(x, group)


class _SumToAll(torch.autograd.Function):
    """Forward: Σ over the ranks; backward: the cotangent unchanged. For a
    loss whose value every rank reports whole (the global loss) while each
    rank backpropagates only its own share: the shares' gradients sum to the
    global loss's."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_to_all(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    return _SumToAll.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """``x`` unchanged, as the input of a column-parallel layer on the model
    ``group``: the backward sums the model ranks' partial input gradients."""
    return _CopyToModel.apply(x, group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.cols = group, x.shape[-1]
        return torch.cat(_all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, c = ctx.group.rank, ctx.cols
        return g[..., r * c : (r + 1) * c].contiguous(), None


def gather_from_model(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Every model rank's column block ``x`` (..., c) concatenated along the
    last dim in model-rank order: (..., m·c). The backward keeps this rank's
    block of the cotangent, which every model rank computes alike."""
    return _GatherFromModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Σ over the model ranks of a partial result (a product whose
    contraction dim is split); the backward passes the cotangent, which
    every model rank computes alike, to each rank's part unchanged."""
    return _SumToAll.apply(x, group)


def all_reduce_grads(params: Iterable[torch.Tensor], group: DataGroup) -> None:
    """Sum every rank's gradients, in place: one all-reduce of all of them
    flattened into one buffer (per dtype). Parameters without a gradient
    are skipped; the identical step gives every rank the same set."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier(group: DataGroup) -> None:
    """Every rank waits for every other: a one-element all-reduce on the
    group's device (on both backends, with no device guessed)."""
    all_reduce_(torch.zeros(1, device=group.device), group)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)


def all_reduce_int(value: int, group: DataGroup, op=dist.ReduceOp.SUM) -> int:
    return int(all_reduce_(torch.tensor([int(value)], dtype=torch.int64, device=group.device), group, op).item())


def broadcast_ints(values: List[int], group: DataGroup) -> List[int]:
    """The group's first rank's ``values`` (int64) on every rank of it."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=group.device)
    calls[f"{group.axis}.broadcast"] += 1
    dist.broadcast(t, src=0 if group.pg is None else dist.get_global_rank(group.pg, 0), group=group.pg)
    return [int(v) for v in t.tolist()]


def tensors_digest(tensors: Iterable[torch.Tensor]) -> bytes:
    """sha256 of the tensors' bytes, in order (a host copy of each)."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.digest()


def assert_same_on_ranks(digest: bytes, group: DataGroup, what: str) -> None:
    """Raise on every rank of the group unless every rank's ``digest``
    equals its first rank's (rank 0 below): rank 0's is broadcast, each
    rank compares, and a MAX all-reduce of the mismatches lets all ranks
    raise together (none waits in a collective)."""
    words = [int.from_bytes(digest[i : i + 7], "little") for i in range(0, len(digest), 7)]
    differs = broadcast_ints(words, group) != words
    if all_reduce_int(differs, group, dist.ReduceOp.MAX):
        side = "differs from" if differs else "matches"
        raise RuntimeError(f"{what} differs between the ranks (rank {group.rank} {side} rank 0)")
