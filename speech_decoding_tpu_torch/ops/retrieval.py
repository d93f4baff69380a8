"""Retrieval ranks over a whole test set without the B×B similarity matrix.

Port of ``speech_decoding_tpu/ops/pallas/retrieval.py`` (K3). For each audio
row i, the rank of the diagonal is the number of brain rows j ≠ i with
cos(Y_i, Z_j) > cos(Y_i, Z_i) — the reference's transposed orientation
[ref: speech_decoding/models.py:226-243]; top-k accuracy is mean(rank < k).
The norms and the diagonal are O(B·D) and are computed here with stock ops,
as the JAX wrapper does; the CUDA kernel (``csrc/retrieval_ranks.cu``) does
the O(B²·D) part in f32 and writes only the (B,) int32 ranks.

``retrieval_ranks`` launches the kernel for CUDA tensors and uses
``retrieval_ranks_plain`` for CPU tensors; it never falls back on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from speech_decoding_tpu_torch.ops import _build


def _prepare(Z: torch.Tensor, Y: torch.Tensor, eps: float):
    """Flattened f32 rows, their norms and the diagonal cosine similarity."""
    B = Z.shape[0]
    y = Y.reshape(B, -1).float().contiguous()
    z = Z.reshape(B, -1).float().contiguous()
    ny = torch.linalg.vector_norm(y, dim=-1)
    nz = torch.linalg.vector_norm(z, dim=-1)
    diag = torch.linalg.vecdot(y, z) / torch.clamp_min(ny * nz, eps)
    return y, z, ny, nz, diag


def _similarity(Z: torch.Tensor, Y: torch.Tensor, eps: float):
    """The whole (B, B) f32 similarity matrix and its precomputed diagonal."""
    y, z, ny, nz, diag = _prepare(Z, Y, eps)
    return (y @ z.T) / torch.clamp_min(ny[:, None] * nz[None, :], eps), diag


def retrieval_ranks_plain(Z: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Reference: the whole similarity matrix, compared with its precomputed
    diagonal; j = i never counts. Z, Y (B, ...) -> (B,) int32."""
    sim, diag = _similarity(Z, Y, eps)
    greater = sim > diag[:, None]
    greater.fill_diagonal_(False)
    return greater.sum(dim=1).to(torch.int32)


def near_tie_rows(Z: torch.Tensor, Y: torch.Tensor, tol: float = 1e-6, eps: float = 1e-8) -> set:
    """Rows whose plain similarity has an off-diagonal entry within ``tol``
    of the diagonal: there another summation order may flip a compare, so
    the kernel's rank may differ from ``retrieval_ranks_plain``'s."""
    sim, diag = _similarity(Z, Y, eps)
    close = (sim - diag[:, None]).abs() < tol
    close.fill_diagonal_(False)
    return set(torch.nonzero(close.any(dim=1)).flatten().tolist())


def _launch(Z: torch.Tensor, Y: torch.Tensor, eps: float) -> torch.Tensor:
    if not (Y.is_cuda and Y.device == Z.device):
        raise ValueError("retrieval_ranks: Z and Y must lie on one CUDA device")
    return _ranks_kernel(*_prepare(Z, Y, eps), eps)


def _ranks_kernel(y, z, ny, nz, diag, eps: float) -> torch.Tensor:
    """The kernel alone, on ``_prepare``'s f32 rows, norms and diagonal."""
    B, D = y.shape
    ranks = torch.zeros(B, dtype=torch.int32, device=y.device)
    if B == 0:
        return ranks
    fn = _build.load("retrieval_ranks").retrieval_ranks_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y.data_ptr(), z.data_ptr(), ny.data_ptr(), nz.data_ptr(), diag.data_ptr(), ranks.data_ptr(),
                 B, D, eps, stream)
    _build.check(err, "retrieval_ranks")
    retrieval_ranks.launches += 1
    return ranks


def retrieval_ranks(Z: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-row rank of the diagonal in the cosine similarity of audio rows Y
    against brain rows Z (both (B, ...), any float dtype, cast to f32).
    Returns (B,) int32."""
    if Z.shape[0] != Y.shape[0] or Z.numel() != Y.numel():
        raise ValueError(f"retrieval_ranks needs Z and Y of one row count and row size, got "
                         f"{tuple(Z.shape)}, {tuple(Y.shape)}")
    if Z.is_cuda:
        return _launch(Z, Y, eps)
    if Z.device.type != "cpu":
        raise ValueError(f"retrieval_ranks runs on CUDA or CPU tensors, got {Z.device}")
    return retrieval_ranks_plain(Z, Y, eps)


retrieval_ranks.launches = 0  # kernel launches (CUDA tensors only)


def retrieval_metrics_kernel(Z: torch.Tensor, Y: torch.Tensor,
                             ks: Sequence[int] = (1, 10)) -> Tuple[torch.Tensor, ...]:
    """Top-k retrieval accuracies from ``retrieval_ranks`` (0-dim f32
    tensors on Z's device): the kernel on the card, its plain version on the
    CPU."""
    ranks = retrieval_ranks(Z, Y)
    return tuple((ranks < k).float().mean() for k in ks)
