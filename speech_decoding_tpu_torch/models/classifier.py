"""Segment-retrieval evaluation (top-1 / top-10 accuracy).

Port of ``speech_decoding_tpu/models/classifier.py``: the reference's O(B²)
Python cosine loop [ref: speech_decoding/models.py:199-248] as one normalized
matmul, scored by the rank of the diagonal in its row (the reference's
argmax / top-k membership up to ties). Rows of the scored matrix index audio
segments and columns brain embeddings, the reference's transposed
orientation [ref: models.py:233].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from speech_decoding_tpu_torch.ops.retrieval import retrieval_metrics_kernel


def cosine_similarity_matrix(Z: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """sim[i, j] = cos(Y_i, Z_j), f32, with the reference's eps guard on the
    norm product [ref: models.py:226-233]."""
    B = Z.shape[0]
    z = Z.reshape(B, -1).float()
    y = Y.reshape(B, -1).float()
    zn = torch.linalg.vector_norm(z, dim=-1)
    yn = torch.linalg.vector_norm(y, dim=-1)
    return (y @ z.T) / torch.clamp_min(torch.outer(yn, zn), eps)


def retrieval_accuracy_from_similarity(similarity: torch.Tensor,
                                       ks: Sequence[int] = (1, 10)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracies of the diagonal within each row, via its rank (the
    number of strictly larger entries) [ref: models.py:236-243]."""
    diag = torch.diagonal(similarity)
    rank = (similarity > diag[:, None]).sum(dim=-1)
    return tuple((rank < k).float().mean() for k in ks)


def retrieval_metrics(Z: torch.Tensor, Y: torch.Tensor,
                      ks: Sequence[int] = (1, 10)) -> Tuple[torch.Tensor, ...]:
    """Top-k retrieval accuracies of brain embeddings Z against audio
    embeddings Y (both (B, F, T)) through the whole similarity matrix."""
    return retrieval_accuracy_from_similarity(cosine_similarity_matrix(Z, Y), ks)


class Classifier:
    """The reference's ``Classifier(args)(Z, Y)`` -> (top1, top10) floats
    [ref: models.py:199-248]. CUDA tensors go through the retrieval-rank
    kernel (K3), so the test set's similarity matrix never exists, as the
    JAX package does on the TPU; CPU tensors through its plain version."""

    def __init__(self, args=None):
        self.factor = 1  # kept for parity [ref: models.py:206]

    def __call__(self, Z: torch.Tensor, Y: torch.Tensor, test: bool = False):
        top1, top10 = retrieval_metrics_kernel(Z, Y, ks=(1, 10))
        return float(top1), float(top10)
