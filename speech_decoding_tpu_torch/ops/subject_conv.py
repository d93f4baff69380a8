"""Per-subject 1x1 conv: ``out[b] = x[b] @ W[subject_idxs[b]]``.

Port of ``speech_decoding_tpu/ops/pallas/subject_conv.py`` (K1). The
SubjectBlock applies a different (D1, D1) matrix to each batch row, selected
by subject id [ref: speech_decoding/models.py:98-116]. The CUDA kernel
(``csrc/subject_matmul.cu``) reads each row's subject id inside the thread
block and streams that subject's weights, so no gathered (B, D1, D1) copy
exists.

``subject_matmul`` is differentiable, as the JAX ``custom_vjp`` is: dX is
the same kernel on g and a contiguous Wᵀ (so a train step launches it
twice), dW the per-row xᵀg in f32 summed by subject (``torch.bmm`` +
``index_add_``; JAX leaves this to XLA's ``segment_sum``, so it stays a
stock op here), cast to W's dtype.

``subject_matmul`` launches the kernel for CUDA tensors and uses
``subject_matmul_plain`` for CPU tensors; it never falls back on the card.
Subject ids may lie on the host: they are checked there and copied over with
the launch, so the host does not wait for the card (the serving encode and
the train step pass them so). Ids on the card are checked there, which costs
one wait for the card. The backward reuses the checked copy.
"""

from __future__ import annotations

import ctypes

import torch

from speech_decoding_tpu_torch.ops import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def subject_matmul_plain(x: torch.Tensor, w: torch.Tensor, subject_idxs: torch.Tensor) -> torch.Tensor:
    """Reference: einsum over the gathered weights, f32 accumulation, output
    in x's dtype. x (B, T, Din); w (S, Din, Dout); subject_idxs (B,) int."""
    wg = w[subject_idxs.long()]
    return torch.einsum("bti,bio->bto", x.float(), wg.float()).to(x.dtype)


def _check_ids(subject_idxs: torch.Tensor, num_subjects: int) -> None:
    # the Pallas index map would read out of bounds silently; raise instead
    # (ids on the card cost one wait for the card, host ids none)
    if subject_idxs.numel() and bool(((subject_idxs < 0) | (subject_idxs >= num_subjects)).any()):
        raise ValueError(
            f"subject ids must lie in [0, {num_subjects}), got "
            f"[{int(subject_idxs.min())}, {int(subject_idxs.max())}]"
        )


def _launch(x: torch.Tensor, w: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"subject_matmul takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if sidx.dtype != torch.int32:
        raise TypeError(f"subject ids must be int32 on the card, got {sidx.dtype}")
    if not (w.is_cuda and sidx.is_cuda and w.device == x.device and sidx.device == x.device):
        raise ValueError("subject_matmul: x, w and subject_idxs must lie on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous() and sidx.is_contiguous()):
        raise ValueError("subject_matmul takes contiguous tensors")
    # the kernel copies tiles in 16-byte pieces: realign a tensor that starts mid-allocation
    x, w = (t.clone() if t.data_ptr() % 16 else t for t in (x, w))
    B, T, Din = x.shape
    out = torch.empty((B, T, w.shape[2]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = getattr(_build.load("subject_matmul"), f"subject_matmul_{_DTYPES[x.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), sidx.data_ptr(), out.data_ptr(),
                 B, T, Din, w.shape[2], stream)
    _build.check(err, "subject_matmul")
    subject_matmul.launches += 1
    return out


def _apply(x: torch.Tensor, w: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    return _launch(x, w, sidx) if x.is_cuda else subject_matmul_plain(x, w, sidx)


class _SubjectMatmul(torch.autograd.Function):
    """Checked ids on x's device in; the JAX ``_fwd``/``_bwd`` pair."""

    @staticmethod
    def forward(ctx, x, w, sidx):
        ctx.save_for_backward(x, w, sidx)
        return _apply(x, w, sidx)

    @staticmethod
    def backward(ctx, g):
        x, w, sidx = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _apply(g.to(x.dtype).contiguous(), w.transpose(1, 2).contiguous(), sidx)
        if ctx.needs_input_grad[1]:
            per_row = torch.bmm(x.float().transpose(1, 2), g.float())  # (B, Din, Dout)
            dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            dw = dw.index_add_(0, sidx.long(), per_row).to(w.dtype)
        return dx, dw, None


def subject_matmul(x: torch.Tensor, w: torch.Tensor, subject_idxs: torch.Tensor) -> torch.Tensor:
    """out[b] = x[b] @ w[subject_idxs[b]]: x (B, T, Din), w (S, Din, Dout),
    subject_idxs (B,), on x's device or on the host. Differentiable in x and
    w. Raises ValueError for an id outside [0, S)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"subject_matmul shapes: x (B, T, Din), w (S, Din, Dout); got {tuple(x.shape)}, {tuple(w.shape)}")
    if subject_idxs.shape != (x.shape[0],):
        raise ValueError(f"subject_idxs must be ({x.shape[0]},), got {tuple(subject_idxs.shape)}")
    _check_ids(subject_idxs, w.shape[0])
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"subject_matmul runs on CUDA or CPU tensors, got {x.device}")
    return _SubjectMatmul.apply(x, w, subject_idxs.to(x.device, non_blocking=True))


subject_matmul.launches = 0  # kernel launches (CUDA tensors only)
