"""The CLIP loss and retrieval over a batch split across the ranks.

Port of ``speech_decoding_tpu/parallel/clip_sharded.py``. The B×B
similarity matrix never exists on one rank:

  * each rank keeps its b = B/W rows and all-gathers the normalized
    counterpart rows (B, D);
  * it computes its (b × B) block of logits;
  * the row-wise cross-entropy is local; the column-wise one takes a
    distributed log-sum-exp (an all-reduce of the column maxima, then of
    the column sums of exponentials);
  * the diagonal of local row i is global column rank·b + i.

A per-rank ``clip_loss`` over b rows would be another loss, with W times
fewer negatives. The loss comes back whole on every rank (its value is the
global loss), while each rank's backward yields its share of the global
loss's gradient (``collectives.sum_to_all``); the train step sums the
shares with one all-reduce. Math in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from speech_decoding_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_, all_reduce_sum, sum_to_all
from speech_decoding_tpu_torch.parallel.mesh import DataGroup


def _normalized(v: torch.Tensor) -> torch.Tensor:
    """(b, D) rows over their L2 norm, in v's dtype with an f32 sum of
    squares, then f32: ``models.loss.clip_logits``'s normalization."""
    v = v.reshape(v.shape[0], -1)
    return (v / torch.linalg.vector_norm(v, dim=-1, dtype=torch.float32)[:, None].to(v.dtype)).float()


def clip_logits_sharded(x: torch.Tensor, y: torch.Tensor, temp: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """This rank's (b, B) block of ``clip_logits(x, y, temp)`` over the
    global batch: the local x̂ rows against every rank's ŷ rows."""
    return (_normalized(x) @ all_gather_rows(_normalized(y), group).T) * torch.exp(temp)


def _diag_cols(b: int, group: DataGroup, device) -> torch.Tensor:
    return group.rank * b + torch.arange(b, device=device)


def clip_loss_sharded(x: torch.Tensor, y: torch.Tensor, temp: torch.Tensor, group: DataGroup,
                      reduction: str = "mean", return_logits: bool = False):
    """Symmetric InfoNCE over the global batch, each rank passing its rows
    of x and y (called as the step calls ``clip_loss(Y, Z)``). Equals
    ``models.loss.clip_loss`` on the concatenated batch; ``reduction`` is
    "mean" (over 2B) or "sum". With ``return_logits`` returns (the local
    (b, B) logits, loss)."""
    b = x.shape[0]
    B = b * group.world
    if B <= 1:
        raise ValueError("Batch size must be greater than 1.")  # [ref: loss.py:40]
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
    logits = clip_logits_sharded(x, y, temp, group)
    rows, cols = torch.arange(b, device=logits.device), _diag_cols(b, group, logits.device)
    diag = logits[rows, cols]
    row_nll = torch.logsumexp(logits, dim=-1) - diag
    # the column log-sum-exp over every rank's rows: the shift is a constant
    # of the function, so the max is taken without a gradient
    col_max = all_reduce_(logits.detach().amax(dim=0), group, dist.ReduceOp.MAX)
    col_sum = all_reduce_sum(torch.exp(logits - col_max).sum(dim=0), group)
    col_nll = torch.log(col_sum[cols]) + col_max[cols] - diag
    local = (row_nll + col_nll).sum() / (2.0 * B if reduction == "mean" else 2.0)
    loss = sum_to_all(local, group)
    return (logits, loss) if return_logits else loss


def accuracy_from_local_similarity(sim: torch.Tensor, group: DataGroup,
                                   ks: Sequence[int] = (1, 10)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracies of the global batch from this rank's (b, B) rows of
    a similarity matrix: each row's diagonal is column rank·b + i, its rank
    the number of strictly larger entries, and the hit counts are summed
    over the ranks. Equals ``retrieval_accuracy_from_similarity`` on the
    whole matrix."""
    b = sim.shape[0]
    diag = sim[torch.arange(b, device=sim.device), _diag_cols(b, group, sim.device)]
    rank = (sim > diag[:, None]).sum(dim=-1)
    hits = all_reduce_(torch.stack([(rank < k).sum() for k in ks]).float(), group)
    return tuple(hits / (b * group.world))


@torch.no_grad()
def retrieval_metrics_sharded(Z: torch.Tensor, Y: torch.Tensor, group: DataGroup, ks: Sequence[int] = (1, 10),
                              eps: float = 1e-8) -> Tuple[torch.Tensor, ...]:
    """Top-k retrieval accuracy over the global batch: each rank scores its
    local audio rows Y against every rank's brain rows Z (the reference's
    orientation, sim[i, j] = cos(Y_i, Z_j) with the eps guard on the norm
    product [ref: models.py:226-233]). Equals ``models.classifier
    .retrieval_metrics`` on the concatenated batch."""
    z = all_gather_rows(Z.reshape(Z.shape[0], -1).float(), group)
    y = Y.reshape(Y.shape[0], -1).float()
    norms = torch.clamp_min(torch.outer(torch.linalg.vector_norm(y, dim=-1), torch.linalg.vector_norm(z, dim=-1)), eps)
    return accuracy_from_local_similarity((y @ z.T) / norms, group, ks)
