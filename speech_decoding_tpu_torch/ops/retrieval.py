"""Retrieval ranks over a whole test set without the B×B similarity matrix.

Port of ``speech_decoding_tpu/ops/pallas/retrieval.py`` (K3). For each audio
row i, the rank of the diagonal is the number of brain rows j ≠ i with
cos(Y_i, Z_j) > cos(Y_i, Z_i) — the reference's transposed orientation
[ref: speech_decoding/models.py:226-243]; top-k accuracy is mean(rank < k).
The CUDA kernels (``csrc/retrieval_ranks.cu``) write only the (B,) int32
ranks.

Routes on the card (``retrieval_ranks.route`` names the last one taken,
``retrieval_ranks.pieces`` its bf16 pieces of y and ``retrieval_ranks.splits``
its depth slices):
  * ``"wgmma"``: Z bf16 and Y f32 or bf16 inside ``_fast_path`` (the eval's
    embeddings in the compute dtype against f32 or bf16 targets). One pass
    (``retrieval_prep``) writes f32 Y as three bf16 pieces that add back to
    it exactly (``split_bf16_pieces``; a bf16 Y is its own one piece) and
    the norms and the diagonal; then bf16 tensor-core products of every
    piece with Z into one f32 accumulator: the f32 dot products up to the
    order of their sums (plain version: ``retrieval_ranks_pieces_plain``).
    With fewer tiles than SMs (the Trainer's eval of 64 segments) the depth
    is split across blocks and the slices' partial tiles added in a fixed
    order. The pieces scratch (P·B·D bf16, 4.5 GB at B = 2048, D = 368,640)
    is dropped when the call returns.
  * ``"f32"``: every other input (f32 Z, D % 8 ≠ 0, a misaligned base): the
    rows cast to f32, norms and diagonal from stock ops as the JAX wrapper
    computes them, and the CUDA-core kernel in f32.

``retrieval_ranks`` launches a kernel for CUDA tensors and uses
``retrieval_ranks_plain`` for CPU tensors; it never falls back on the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import FLOAT, INT, LONG, PTR

LIB = _build.Library("retrieval_ranks", {
    "retrieval_ranks_f32": [PTR] * 6 + [INT, LONG, FLOAT],
    "retrieval_prep": [PTR] * 7 + [INT, LONG, INT, INT, FLOAT],
    "retrieval_ranks_wgmma": [PTR] * 7 + [INT, LONG, INT, INT, FLOAT],
})
PREP_SLICE = 8192  # depth a preparation block (k3::PREP_SLICE)
TILE = (64, 256)  # (i, j) a block of the wgmma body (k3::TM, k3::TN)
CHUNK = 64  # depth a stage of the wgmma body (k3::BK)


def _fast_path(B: int, D: int, z_dtype: torch.dtype, y_dtype: torch.dtype, ptrs: Sequence[int]) -> bool:
    """Whether ranks of Z (B, D) against Y (B, D) take the ``wgmma`` body:
    Z bf16 (exact as one bf16 piece), Y f32 or bf16, rows of whole 16-byte
    pieces for the tensor maps (D % 8 == 0), every base in ``ptrs`` 16-byte
    aligned, and something to rank (B, D > 0)."""
    return (B > 0 and D > 0 and D % 8 == 0 and z_dtype == torch.bfloat16
            and y_dtype in (torch.float32, torch.bfloat16) and all(p % 16 == 0 for p in ptrs))


def split_bf16_pieces(y: torch.Tensor) -> torch.Tensor:
    """y (B, D) as bf16 pieces (P, B, D) that add back to it: a bf16 y is
    its own one piece; f32 y gives y1 = bf16(y), y2 = bf16(y - y1), y3 =
    bf16(y - y1 - y2), each subtraction exact in f32 (for normal numbers
    the three pieces hold all 24 significant bits). The plain version of
    the preparation kernel's split."""
    if y.dtype == torch.bfloat16:
        return y[None]
    if y.dtype != torch.float32:
        raise ValueError(f"split_bf16_pieces takes f32 or bf16, got {y.dtype}")
    y1 = y.bfloat16()
    r1 = y - y1.float()
    y2 = r1.bfloat16()
    return torch.stack([y1, y2, (r1 - y2.float()).bfloat16()])


def _prepare(Z: torch.Tensor, Y: torch.Tensor, eps: float):
    """Flattened f32 rows, their norms and the diagonal cosine similarity."""
    B = Z.shape[0]
    y = Y.reshape(B, -1).float().contiguous()
    z = Z.reshape(B, -1).float().contiguous()
    ny = torch.linalg.vector_norm(y, dim=-1)
    nz = torch.linalg.vector_norm(z, dim=-1)
    diag = torch.linalg.vecdot(y, z) / torch.clamp_min(ny * nz, eps)
    return y, z, ny, nz, diag


def _count(dots: torch.Tensor, ny, nz, diag, eps: float) -> torch.Tensor:
    """The epilogue: per row, the off-diagonal similarities above the diagonal."""
    greater = dots / torch.clamp_min(ny[:, None] * nz[None, :], eps) > diag[:, None]
    greater.fill_diagonal_(False)
    return greater.sum(dim=1).to(torch.int32)


def _similarity(Z: torch.Tensor, Y: torch.Tensor, eps: float):
    """The whole (B, B) f32 similarity matrix and its precomputed diagonal."""
    y, z, ny, nz, diag = _prepare(Z, Y, eps)
    return (y @ z.T) / torch.clamp_min(ny[:, None] * nz[None, :], eps), diag


def retrieval_ranks_plain(Z: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Reference: the whole similarity matrix, compared with its precomputed
    diagonal; j = i never counts. Z, Y (B, ...) -> (B,) int32."""
    y, z, ny, nz, diag = _prepare(Z, Y, eps)
    return _count(y @ z.T, ny, nz, diag, eps)


def retrieval_ranks_pieces_plain(Z: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The ``wgmma`` body's arithmetic in plain PyTorch: the dot products as
    Σ_p y_p @ z.T over ``split_bf16_pieces`` of Y (f32 or bf16), each in
    f32, then ``retrieval_ranks_plain``'s epilogue on the same norms and
    diagonal. Z is bf16 on that route (it is cast to f32 here)."""
    B = Z.shape[0]
    _, z, ny, nz, diag = _prepare(Z, Y, eps)
    dots = None
    for piece in split_bf16_pieces(Y.reshape(B, -1)):
        part = piece.float() @ z.T
        dots = part if dots is None else dots + part
    return _count(dots, ny, nz, diag, eps)


def near_tie_rows(Z: torch.Tensor, Y: torch.Tensor, tol: float = 1e-6, eps: float = 1e-8) -> set:
    """Rows whose plain similarity has an off-diagonal entry within ``tol``
    of the diagonal: there another summation order may flip a compare, so
    the kernel's rank may differ from ``retrieval_ranks_plain``'s."""
    sim, diag = _similarity(Z, Y, eps)
    close = (sim - diag[:, None]).abs() < tol
    close.fill_diagonal_(False)
    return set(torch.nonzero(close.any(dim=1)).flatten().tolist())


def _splits(B: int, D: int, sms: int) -> int:
    """Depth slices of the ``wgmma`` body: as many as keep slices × tiles
    within one block a SM (so the workspace is at most ``sms`` partial
    tiles), none empty; 1 when the tiles alone fill the card."""
    tiles = math.ceil(B / TILE[0]) * math.ceil(B / TILE[1])
    chunks = math.ceil(D / CHUNK)
    per = math.ceil(chunks / max(1, min(chunks, sms // tiles)))
    return math.ceil(chunks / per)


def _prep(z: torch.Tensor, y: torch.Tensor, eps: float):
    """The preparation kernel on flattened rows: (pieces (P, B, D) bf16, ny,
    nz, diag). For bf16 y the pieces are y itself, not copied."""
    B, D = y.shape
    f32 = y.dtype == torch.float32
    pieces = torch.empty((3, B, D), dtype=torch.bfloat16, device=y.device) if f32 else y[None]
    nsl = math.ceil(D / PREP_SLICE)
    part = torch.empty(B * nsl * 3, dtype=torch.float32, device=y.device)
    ny, nz, diag = torch.empty((3, B), dtype=torch.float32, device=y.device)
    LIB("retrieval_prep", y.device, y, z, pieces if f32 else None, part, ny, nz, diag, B, D, int(f32), nsl, eps)
    return pieces, ny, nz, diag


def _products(pieces: torch.Tensor, z: torch.Tensor, ny, nz, diag, eps: float) -> torch.Tensor:
    """The ``wgmma`` body's products and counts on ``_prep``'s outputs."""
    P, B, D = pieces.shape
    splits = _splits(B, D, _build.sms(z.device))
    tiles = math.ceil(B / TILE[0]) * math.ceil(B / TILE[1])
    ws = torch.empty(splits * tiles * TILE[0] * TILE[1] if splits > 1 else 0, dtype=torch.float32,
                     device=z.device)
    ranks = torch.zeros(B, dtype=torch.int32, device=z.device)
    LIB("retrieval_ranks_wgmma", z.device, pieces, z, ny, nz, diag, ranks, ws if splits > 1 else None, B, D, P,
        splits, eps)
    retrieval_ranks.launches += 1
    retrieval_ranks.route, retrieval_ranks.pieces, retrieval_ranks.splits = "wgmma", P, splits
    return ranks


def _ranks_kernel(y, z, ny, nz, diag, eps: float) -> torch.Tensor:
    """The f32 CUDA-core kernel alone, on ``_prepare``'s f32 rows, norms and diagonal."""
    B, D = y.shape
    ranks = torch.zeros(B, dtype=torch.int32, device=y.device)
    if B == 0:
        return ranks
    LIB("retrieval_ranks_f32", y.device, y, z, ny, nz, diag, ranks, B, D, eps)
    retrieval_ranks.launches += 1
    retrieval_ranks.route, retrieval_ranks.pieces, retrieval_ranks.splits = "f32", None, 1
    return ranks


def _launch(Z: torch.Tensor, Y: torch.Tensor, eps: float) -> torch.Tensor:
    if not (Y.is_cuda and Y.device == Z.device):
        raise ValueError("retrieval_ranks: Z and Y must lie on one CUDA device")
    B = Z.shape[0]
    z, y = Z.reshape(B, -1).contiguous(), Y.reshape(B, -1).contiguous()
    if _fast_path(B, z.shape[1], z.dtype, y.dtype, (z.data_ptr(), y.data_ptr())):
        pieces, ny, nz, diag = _prep(z, y, eps)
        return _products(pieces, z, ny, nz, diag, eps)
    return _ranks_kernel(*_prepare(Z, Y, eps), eps)


def retrieval_ranks(Z: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-row rank of the diagonal in the cosine similarity of audio rows Y
    against brain rows Z (both (B, ...), any float dtype). Returns (B,)
    int32."""
    if Z.shape[0] != Y.shape[0] or Z.numel() != Y.numel():
        raise ValueError(f"retrieval_ranks needs Z and Y of one row count and row size, got "
                         f"{tuple(Z.shape)}, {tuple(Y.shape)}")
    if Z.is_cuda:
        return _launch(Z, Y, eps)
    if Z.device.type != "cpu":
        raise ValueError(f"retrieval_ranks runs on CUDA or CPU tensors, got {Z.device}")
    return retrieval_ranks_plain(Z, Y, eps)


retrieval_ranks.launches = 0  # calls that launched a body: one a call on the card
retrieval_ranks.route = None  # "wgmma" or "f32": the body of the last launch
retrieval_ranks.pieces = None  # bf16 pieces of y in the last wgmma launch (3 for f32 Y, 1 for bf16)
retrieval_ranks.splits = 1  # depth slices of the last launch


def retrieval_metrics_kernel(Z: torch.Tensor, Y: torch.Tensor,
                             ks: Sequence[int] = (1, 10)) -> Tuple[torch.Tensor, ...]:
    """Top-k retrieval accuracies from ``retrieval_ranks`` (0-dim f32
    tensors on Z's device): the kernel on the card, its plain version on the
    CPU."""
    ranks = retrieval_ranks(Z, Y)
    return tuple((ranks < k).float().mean() for k in ks)
