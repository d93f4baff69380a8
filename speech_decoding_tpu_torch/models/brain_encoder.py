"""Brain encoder: Fourier-parameterized spatial attention + per-subject 1x1
convs + dilated-GLU conv stack, in eval and train mode.

Port of ``speech_decoding_tpu/models/brain_encoder.py`` (the reference's
speech_decoding/models.py: SpatialAttention models.py:14-65, SpatialDropout
models.py:68-86, SubjectBlock models.py:89-117, ConvBlock models.py:120-166,
BrainEncoder models.py:169-196). Same function, same parameter names and
layouts as the flax modules, so ``models.params_bridge`` moves weights
across unchanged:

  * internal layout (batch, time, channels); conv kernels (k, in, out);
    ``__call__`` takes the reference layout (B, C, T) unless
    ``channels_last_io``;
  * parameters are f32, compute runs in ``compute_dtype``; BatchNorm
    normalizes in the compute dtype from f32 running statistics;
  * the per-subject layer goes through ``ops.subject_conv.subject_matmul``
    (K1, forward and backward), the hand-written kernel for CUDA tensors (its
    plain version on the CPU);
  * every k=3 conv is ``TapConv``, the JAX ``_gemm_conv`` custom VJP, dW
    through ``ops.tap_conv.tap_conv_dw`` (K2). On the card its forward (the
    bias folded in) and its dx each add the three taps inside cuBLAS: the
    centre tap over the flat rows, the shifted ones by strided-batched GEMMs
    with beta = 1 into row-offset views, with no pad, copy or add; on the
    CPU it runs JAX's shifted-slice sums. Under ``conv_impl="pallas_taps"``
    it is ``ops.tap_conv.PallasTapConv`` instead: K5 forward and for dx, K2
    for dW;
  * train mode normalizes with batch statistics and updates the running
    ones in place (torch.nn.BatchNorm1d semantics), and applies one spatial
    dropout mask to the whole batch; under a data-parallel ``group`` the
    statistics are those of the global batch (synchronized BatchNorm, as
    GSPMD gives JAX's module path on a mesh). On the card, with no group,
    a bf16 block's skip add, train-mode BatchNorm and GELU run as one op,
    ``ops.batchnorm_gelu`` (hand-written kernels, two passes each way);
  * the ConvBlock's GLU runs as one op, ``ops.glu`` (a hand-written kernel
    each way), on the card's bf16 activations, in every mode and under any
    group (it is elementwise); the CPU and f32 keep ``a * torch.sigmoid(b)``;
  * GELU is exact (erf); initializers match torch defaults
    (U(±1/sqrt(fan_in)) for conv weights and biases, U(0, 1) for z), drawn
    from the caller's ``torch.Generator``;
  * ``remat`` (``tpu.remat``; JAX's ``nn.remat(ConvBlock)``) recomputes each
    ConvBlock in the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, non-reentrant: the backward runs the
    forward pass's graph, and the recomputation only refills the tensors it
    saved). As in flax, the running statistics move once a step: the
    recomputation writes no buffer, and under a ``group`` it reuses the
    forward's global BatchNorm sums instead of all-reducing again, so a
    step makes the same collectives with and without remat;
  * on a ("data", "model") grid (``parallel.sharding_rules
    .partition_encoder``) a module whose parameter is split holds its
    column block and the grid's ``model_group``, and runs column-parallel:
    ``copy_to_model`` on its input, its product on the block (K2's dW and
    K1 on the block's columns), ``gather_from_model`` of the output, then
    the whole bias. The spatial attention's split is K², the contraction
    dim of its logits: the partial logits go through ``reduce_from_model``
    before the softmax. Under ``pallas_taps`` a split k=3 conv gathers its
    kernel and runs K5 on the whole weights, as JAX's GSPMD gathers a
    ``P(..., "model")`` parameter before a Pallas call. BatchNorm runs on
    whole channels after the gathers, its sums over the ``group`` passed to
    ``forward`` (the grid's data axis). Every model rank then runs the same
    graph on the same rows, which the three collectives' backwards assume.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as Fn
from torch.utils.checkpoint import checkpoint

from speech_decoding_tpu_torch.ops import batchnorm_gelu as bn_gelu
from speech_decoding_tpu_torch.ops import glu
from speech_decoding_tpu_torch.ops.conv_block import dilations
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul
from speech_decoding_tpu_torch.ops.tap_conv import PallasTapConv, tap_conv_dw
from speech_decoding_tpu_torch.parallel.collectives import (
    all_reduce_sum, copy_to_model, gather_from_model, kept_all_reduce_sum, reduce_from_model,
)
from speech_decoding_tpu_torch.parallel.mesh import DataGroup, ModelGroup

# tpu.conv_impl values: all compute the same function. The port runs the
# first four through TapConv (so every train step on the card runs K2) and
# pallas_taps through PallasTapConv (K5 and K2)
_SAME_CONV_IMPLS = ("xla", "gemm", "gemm_pdw", "gemm_wide")
CONV_IMPLS = _SAME_CONV_IMPLS + ("pallas_taps",)


def _uniform(shape, bound: float, generator, low: Optional[float] = None) -> nn.Parameter:
    lo = -bound if low is None else low
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(lo, bound, generator=generator)
    return nn.Parameter(t)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return Fn.gelu(x, approximate="none")


_REMAT = threading.local()  # .stash: the _RematStash of the ConvBlock running under remat, if any


class _RematStash:
    """One rematerialized ConvBlock call: the global BatchNorm sums its
    forward pass computed (under a group), in call order, and whether the
    block now runs as the backward pass's recomputation. ``contexts`` is
    the ``context_fn`` of ``torch.utils.checkpoint``."""

    def __init__(self):
        self.sums = []
        self.replaying = False
        self.pos = 0

    @contextlib.contextmanager
    def _active(self, replaying: bool):
        prev = getattr(_REMAT, "stash", None)
        _REMAT.stash, self.replaying, self.pos = self, replaying, 0
        try:
            yield
        finally:
            _REMAT.stash = prev

    def contexts(self):
        return self._active(False), self._active(True)

    def next_sums(self) -> torch.Tensor:
        self.pos += 1
        return self.sums[self.pos - 1]


class TorchBatchNorm(nn.Module):
    """BatchNorm over (batch, time) per channel with torch.nn.BatchNorm1d
    semantics [ref: models.py:135,143]: parameters ``scale``/``bias`` and
    running ``mean``/``var`` (buffers), all f32. In train mode the batch
    statistics are the f32 mean and E[x²] − mean² over (B, T), and the
    running ones move by momentum 0.1 towards the mean and the unbiased
    variance (n = B·T), in place. Under a data-parallel ``group`` each
    rank passes its own rows: the per-channel (Σx, Σx²) are summed over the
    ranks by a differentiable all-reduce (whose backward sums the
    cotangents, so each rank's gradient is its share of the global one),
    and the mean, variance and n = W·B·T are the global batch's, identical
    on every rank. Inside a rematerialized block's recomputation the
    running statistics are left alone, and under a group the sums are the
    ones the forward pass kept (``kept_all_reduce_sum``: the same value and
    backward, no collective)."""

    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5, compute_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False, group: Optional[DataGroup] = None) -> torch.Tensor:
        if train:
            stash = getattr(_REMAT, "stash", None)
            replaying = stash is not None and stash.replaying
            n = x.shape[0] * x.shape[1]
            if group is None:
                mean, var = bn_gelu.batch_moments(x)
            else:
                n *= group.world
                xf = x.float()
                local = torch.stack([xf.sum(dim=(0, 1)), (xf * xf).sum(dim=(0, 1))])
                if replaying:
                    sums = kept_all_reduce_sum(local, stash.next_sums(), group)
                else:
                    sums = all_reduce_sum(local, group)
                    if stash is not None:
                        stash.sums.append(sums.detach())
                mean = sums[0] / n
                var = sums[1] / n - mean * mean
            if not replaying:
                bn_gelu.move_running(self.mean, self.var, mean, var, n, self.momentum)
        else:
            mean, var = self.mean, self.var
        # normalize in the compute dtype (exact f32 when compute_dtype is f32)
        return bn_gelu.normalize(x, mean, var, self.scale, self.bias, self.eps, self.compute_dtype)

    def gelu(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None, train: bool = False,
             group: Optional[DataGroup] = None) -> torch.Tensor:
        """GELU(BN(x + skip)). In train mode with no ``group`` on a bf16
        activation the card's kernels take (``ops.batchnorm_gelu``), one
        differentiable op: the same formulas, the running statistics moved
        in place (left alone in a remat recomputation). Otherwise the add,
        ``forward`` and GELU as separate ops."""
        if train and group is None and self.compute_dtype == torch.bfloat16 and bn_gelu.takes(x):
            stash = getattr(_REMAT, "stash", None)
            return bn_gelu.bn_gelu_train(x, skip, self.scale, self.bias, self.mean, self.var, self.eps,
                                         self.momentum, update=stash is None or not stash.replaying)
        if skip is not None:
            x = x + skip
        return _gelu(self(x, train, group))


def _conv_taps(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """y[t] = Σ_j x[t + (j−1)·d] @ W_j: three shifted full-width GEMMs in x's
    dtype, zero padding at the edges. x (B, T, Cin); w (3, Cin, Cout). The
    plain version, and ``TapConv``'s route on the CPU."""
    B, T, Cin = x.shape
    xp = Fn.pad(x, (0, 0, d, d))
    y = None
    for j in range(3):
        yj = (xp[:, j * d : j * d + T].reshape(B * T, Cin) @ w[j]).reshape(B, T, -1)
        y = yj if y is None else y + yj
    return y


def _conv_taps_dx(g: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """dx = Σ_j shift_{-j}(g @ W_jᵀ): the mirrored shifted-slice sum in g's
    dtype. g (B, T, Cout); w (3, Cin, Cout). The plain version, and
    ``TapConv``'s route on the CPU."""
    B, T, _ = g.shape
    gf = g.reshape(B * T, -1)
    dx = None
    for j in range(3):
        hj = Fn.pad((gf @ w[j].T).reshape(B, T, -1), (0, 0, d, d))
        dxj = hj[:, 2 * d - j * d : 2 * d - j * d + T]
        dx = dxj if dx is None else dx + dxj
    return dx


def _conv_taps_accum(x: torch.Tensor, w: torch.Tensor, d: int,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_conv_taps`` (plus ``bias``) with the taps accumulated inside the
    GEMMs, ``TapConv``'s route on the card: the centre tap over the flat
    rows with the bias folded in, then each shifted tap added (beta = 1) by a
    strided-batched GEMM into the rows of y it reaches, one recording a
    batch, its weight expanded with batch stride 0. No pad, copy or
    elementwise add: three GEMM launches, each rounding once to x's dtype
    (f32 accumulation within a launch). A dilation ≥ T leaves the centre
    tap alone."""
    B, T, Cin = x.shape
    x = x.contiguous()
    xf = x.view(B * T, Cin)
    y = (xf @ w[1] if bias is None else torch.addmm(bias, xf, w[1])).view(B, T, -1)
    if d < T:
        y[:, d:].baddbmm_(x[:, : T - d], w[0].expand(B, -1, -1))
        y[:, : T - d].baddbmm_(x[:, d:], w[2].expand(B, -1, -1))
    return y


def _conv_taps_dx_accum(g: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """``_conv_taps_dx`` the same way: dx[s] = g[s+d] W_0ᵀ + g[s] W_1ᵀ +
    g[s−d] W_2ᵀ, the centre tap over the flat rows, the shifted ones added
    into row-offset views of dx. Three GEMM launches."""
    B, T, Cout = g.shape
    g = g.contiguous()
    dx = (g.view(B * T, Cout) @ w[1].T).view(B, T, -1)
    if d < T:
        dx[:, : T - d].baddbmm_(g[:, d:], w[0].T.expand(B, -1, -1))
        dx[:, d:].baddbmm_(g[:, : T - d], w[2].T.expand(B, -1, -1))
    return dx


def _accumulates(t: torch.Tensor) -> bool:
    """Whether ``TapConv`` takes the accumulated route for ``t``: on the card."""
    return t.is_cuda


class TapConv(torch.autograd.Function):
    """The dilated k=3 'SAME' conv with the JAX ``_gemm_conv`` custom VJP
    (``models/brain_encoder.py:162-228`` of the JAX package), plus an
    optional bias (broadcast over the last dim):
      dx  = Σ_j shift_{-j}(g @ W_jᵀ), GEMMs in the primal dtype;
      dW  = ``tap_conv_dw(x, g, d)`` (K2 on the card), cast to g's dtype;
      db  = g summed over (B, T).
    On the card the taps accumulate inside the GEMMs (``_conv_taps_accum``,
    ``_conv_taps_dx_accum``); on the CPU it runs the shifted-slice sums of
    JAX's function (``_conv_taps``, ``_conv_taps_dx``) and adds the bias
    after them."""

    @staticmethod
    def forward(ctx, x, w, dilation: int, bias=None):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        ctx.has_bias = bias is not None
        if _accumulates(x):
            return _conv_taps_accum(x, w, dilation, bias)
        y = _conv_taps(x, w, dilation)
        return y if bias is None else y + bias

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (_conv_taps_dx_accum if _accumulates(g) else _conv_taps_dx)(g, w, d)
        if ctx.needs_input_grad[1]:
            dw = tap_conv_dw(x.contiguous(), g, d).to(g.dtype)
        if ctx.has_bias and ctx.needs_input_grad[3]:
            db = g.sum(dim=(0, 1))
        return dx, dw, None, db


class Conv1d(nn.Module):
    """1-D conv in (B, T, C) layout, torch-default init, 'SAME' padding:
    k=1 is one flat (B·T, Cin) GEMM, k=3 is ``TapConv`` (three tap GEMMs,
    the bias folded in where the kernel is whole; dW through K2), or
    ``PallasTapConv`` (K5, dW through K2) when ``impl`` is "pallas_taps".
    The encoder has no other kernel size, and K2 and K5 compute exactly
    three taps, so others raise ValueError.
    With a ``model_group`` the kernel is this rank's column block (module
    docstring)."""

    model_group: Optional[ModelGroup] = None

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 dilation: int = 1, compute_dtype=torch.float32, generator=None, impl: str = "gemm"):
        super().__init__()
        if kernel_size not in (1, 3):
            raise ValueError(f"Conv1d takes kernel_size 1 or 3 (K2 computes three taps), got {kernel_size}")
        if impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv impl {impl!r}")
        self.impl = impl
        self.dilation = dilation
        self.compute_dtype = compute_dtype
        bound = 1.0 / math.sqrt(in_features * kernel_size)
        self.kernel = _uniform((kernel_size, in_features, features), bound, generator)
        self.bias = _uniform((features,), bound, generator)

    def whole_kernel(self) -> torch.Tensor:
        """The whole (k, in, out) kernel: gathered over the model group when
        split (differentiable; every model rank must call)."""
        return self.kernel if self.model_group is None else gather_from_model(self.kernel, self.model_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        w = self.kernel.to(dt)
        mg = self.model_group
        if mg is not None and self.impl == "pallas_taps" and w.shape[0] == 3:
            w, mg = gather_from_model(w, mg), None
        if mg is not None:
            x = copy_to_model(x, mg)
        B, T, Cin = x.shape
        if w.shape[0] == 1:
            y = (x.reshape(B * T, Cin) @ w[0]).reshape(B, T, -1)
        elif self.impl == "pallas_taps":
            y = PallasTapConv.apply(x.contiguous(), w.contiguous(), self.dilation)
        elif mg is None:
            return TapConv.apply(x, w, self.dilation, self.bias.to(dt))
        else:
            y = TapConv.apply(x, w, self.dilation)
        if mg is not None:
            y = gather_from_model(y, mg)
        return y + self.bias.to(dt)


def fourier_bases(loc: np.ndarray, K: int) -> Tuple[np.ndarray, np.ndarray]:
    """(K², C) cos/sin bases of the spatial attention, in numpy exactly as the
    JAX package builds them (kl-major grid [ref: models.py:21-26])."""
    loc = np.asarray(loc, np.float32)
    k = np.arange(K, dtype=np.float32).repeat(K)
    l = np.tile(np.arange(K, dtype=np.float32), K)
    phi = 2 * np.pi * (np.outer(k, loc[:, 0]) + np.outer(l, loc[:, 1]))
    return np.cos(phi), np.sin(phi)


def dropout_mask_at(loc, center_idx: int, d_drop: float) -> torch.Tensor:
    """(C,) f32 mask: 0 for every sensor within Euclidean distance ``d_drop``
    of sensor ``center_idx``, 1 elsewhere [ref: models.py:77-84]."""
    loc = torch.as_tensor(np.asarray(loc, np.float32))
    distances = torch.linalg.vector_norm(loc - loc[int(center_idx)], dim=-1)
    return torch.where(distances < d_drop, 0.0, 1.0)


def spatial_dropout_mask(generator: Optional[torch.Generator], loc, d_drop: float) -> torch.Tensor:
    """Train-time spatial dropout: one random centre sensor for the whole
    batch, drawn from ``generator`` (a CPU generator; None takes torch's
    default). Returns the (C,) mask on the CPU. JAX draws its centre from a
    threefry key, so the two streams differ; tests hand the port JAX's mask."""
    center = torch.randint(0, len(loc), (), generator=generator)
    return dropout_mask_at(loc, int(center), d_drop)


class SpatialAttention(nn.Module):
    """Fourier-parameterized spatial re-mixing of sensor channels
    [ref: models.py:14-65]: logits a = Re(z)·cos(phi) + Im(z)·sin(phi),
    softmax over channels in f32, then a channel mix in the compute dtype. A
    ``drop_mask`` (C,) zeroes dropped sensors first (train mode). With a
    ``model_group``, z holds this rank's block of the K² columns and the
    bases the same rows: the partial logits are summed over the model
    ranks."""

    model_group: Optional[ModelGroup] = None

    def __init__(self, D1: int, K: int, loc: np.ndarray, compute_dtype=torch.float32, generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.z_re = _uniform((D1, K * K), 1.0, generator, low=0.0)
        self.z_im = _uniform((D1, K * K), 1.0, generator, low=0.0)
        cos_b, sin_b = fourier_bases(loc, K)
        self.register_buffer("cos_b", torch.from_numpy(np.asarray(cos_b, np.float32)), persistent=False)
        self.register_buffer("sin_b", torch.from_numpy(np.asarray(sin_b, np.float32)), persistent=False)

    def forward(self, X: torch.Tensor, drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = self.z_re @ self.cos_b + self.z_im @ self.sin_b  # (D1, C)
        if self.model_group is not None:
            a = reduce_from_model(a, self.model_group)
        wts = torch.softmax(a, dim=-1).to(self.compute_dtype)
        X = X.to(self.compute_dtype)
        if drop_mask is not None:
            X = X * drop_mask.to(X.device, self.compute_dtype, non_blocking=True)
        return X @ wts.T  # (B, T, C) -> (B, T, D1)


class SubjectBlock(nn.Module):
    """SpatialAttention -> shared 1x1 conv -> per-subject bias-free 1x1 conv
    [ref: models.py:89-117]. ``subject_kernel`` is (S, D1_in, D1_out); with
    a ``model_group``, this rank's block of D1_out, through K1."""

    model_group: Optional[ModelGroup] = None

    def __init__(self, num_subjects: int, D1: int, K: int, loc: np.ndarray,
                 compute_dtype=torch.float32, generator=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.spatial_attention = SpatialAttention(D1, K, loc, compute_dtype, generator)
        self.conv = Conv1d(D1, D1, 1, compute_dtype=compute_dtype, generator=generator)
        self.subject_kernel = _uniform((num_subjects, D1, D1), 1.0 / math.sqrt(D1), generator)

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor,
                drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        X = self.conv(self.spatial_attention(X, drop_mask))
        W = self.subject_kernel.to(self.compute_dtype)
        mg = self.model_group
        if mg is None:
            return subject_matmul(X.contiguous(), W.contiguous(), subject_idxs)
        return gather_from_model(subject_matmul(copy_to_model(X, mg).contiguous(), W.contiguous(), subject_idxs), mg)


class ConvBlock(nn.Module):
    """Dilated conv block with residual skips, BN + GELU and a GLU output
    [ref: models.py:120-166]; dilations 2^((2k)%5), 2^((2k+1)%5) and 2."""

    def __init__(self, k: int, in_features: int, D2: int, compute_dtype=torch.float32, generator=None,
                 conv_impl: str = "gemm"):
        super().__init__()
        self.k = k
        d0, d1 = dilations(k)
        dt = compute_dtype
        self.conv0 = Conv1d(in_features, D2, 3, d0, dt, generator, conv_impl)
        self.batchnorm0 = TorchBatchNorm(D2, compute_dtype=dt)
        self.conv1 = Conv1d(D2, D2, 3, d1, dt, generator, conv_impl)
        self.batchnorm1 = TorchBatchNorm(D2, compute_dtype=dt)
        self.conv2 = Conv1d(D2, 2 * D2, 3, 2, dt, generator, conv_impl)

    def forward(self, X: torch.Tensor, train: bool = False, group: Optional[DataGroup] = None) -> torch.Tensor:
        # the skip of X from block 1 on [ref: models.py:156], and of Y
        Y = self.batchnorm0.gelu(self.conv0(X), X if self.k > 0 else None, train, group)
        Y = self.batchnorm1.gelu(self.conv1(Y), Y, train, group)
        Y = self.conv2(Y)
        # GLU over channels [ref: models.py:164]: one op on the card's bf16 activations
        return glu.glu(Y) if glu.takes(Y) else glu.glu_plain(Y)


class BrainEncoder(nn.Module):
    """SubjectBlock -> 5 ConvBlocks -> two 1x1 heads with GELU
    [ref: models.py:169-196]. Public layout matches the reference: X (B, C, T)
    -> Z (B, F, T); with ``channels_last_io`` X (B, T, C) -> Z (B, T, F).
    ``conv_impl`` "pallas_taps" runs the k=3 convs through K5; every other
    value of ``CONV_IMPLS`` through ``TapConv``. ``remat``: a train forward
    that records gradients keeps only each ConvBlock's input and recomputes
    the block in the backward pass (the module docstring); eval, a forward
    without gradients and ``fused_train_forward`` (which runs K6, not the
    blocks) are unchanged."""

    def __init__(self, num_subjects: int, loc: np.ndarray, D1: int = 270, D2: int = 320,
                 F: int = 1024, K: int = 32, d_drop: float = 0.1, compute_dtype=torch.float32,
                 channels_last_io: bool = False, generator: Optional[torch.Generator] = None,
                 conv_impl: str = "gemm", remat: bool = False):
        super().__init__()
        self.num_subjects, self.D1, self.D2, self.F, self.K = num_subjects, D1, D2, F, K
        self.remat = remat
        self.d_drop = d_drop
        self.loc = np.asarray(loc, np.float32)
        self.compute_dtype = compute_dtype
        self.channels_last_io = channels_last_io
        dt = compute_dtype
        self.subject_block = SubjectBlock(num_subjects, D1, K, self.loc, dt, generator)
        for k in range(5):
            setattr(self, f"conv{k}", ConvBlock(k, D1 if k == 0 else D2, D2, dt, generator, conv_impl))
        self.conv_final1 = Conv1d(D2, 2 * D2, 1, compute_dtype=dt, generator=generator)
        self.conv_final2 = Conv1d(2 * D2, F, 1, compute_dtype=dt, generator=generator)

    @property
    def conv_blocks(self):
        return [getattr(self, f"conv{k}") for k in range(5)]

    @classmethod
    def from_config(cls, args, loc, num_subjects: int, generator=None) -> "BrainEncoder":
        """Encoder of a config. ``tpu.use_pallas`` is not read: it picks the
        JAX package's TPU kernels, while the port's kernel wrappers follow the
        device of their tensors. ``tpu.conv_impl`` 'xla', 'gemm', 'gemm_pdw'
        and 'gemm_wide' compute the same function and all run ``TapConv``
        (dW through K2); 'pallas_taps' runs ``PallasTapConv`` (K5, dW through
        K2). ``tpu.remat`` recomputes the ConvBlocks in the backward pass."""
        impl = str(args.select("tpu.conv_impl", "xla"))
        if impl not in CONV_IMPLS:
            raise ValueError(f"unknown tpu.conv_impl {impl!r}")
        F = 1024 if args.preprocs["last4layers"] else args.F  # [ref: models.py:176]
        dtype = getattr(torch, str(args.select("tpu.compute_dtype", "float32")))
        return cls(
            num_subjects=num_subjects, loc=loc, D1=args.D1, D2=args.D2, F=F, K=args.K,
            d_drop=float(args.d_drop), compute_dtype=dtype,
            channels_last_io=bool(args.select("tpu.channels_last_io", False)),
            generator=generator, conv_impl="pallas_taps" if impl == "pallas_taps" else "gemm",
            remat=bool(args.select("tpu.remat", False)),
        )

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor, train: bool = False,
                drop_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, group: Optional[DataGroup] = None) -> torch.Tensor:
        """Z from X. ``train`` uses batch statistics (updating the running
        ones in place) and spatial dropout: the (C,) ``drop_mask`` if given
        (the tests pass the mask JAX draws), else one drawn from
        ``generator``. ``group``: X is this rank's block of a data-parallel
        batch and the BatchNorm statistics are the global batch's."""
        if drop_mask is not None and not train:
            raise ValueError("drop_mask applies in train mode only")
        if train and drop_mask is None:
            drop_mask = spatial_dropout_mask(generator, self.loc, self.d_drop)
        if not self.channels_last_io:
            X = X.transpose(-1, -2)  # reference (B, C, T) -> internal (B, T, C)
        X = self.subject_block(X.to(self.compute_dtype), subject_idxs, drop_mask)
        remat = self.remat and train and torch.is_grad_enabled()
        for blk in self.conv_blocks:
            if remat:
                # a ConvBlock draws no random numbers: no RNG state to restore
                X = checkpoint(blk, X, train, group, use_reentrant=False, preserve_rng_state=False,
                               context_fn=_RematStash().contexts)
            else:
                X = blk(X, train, group)
        X = _gelu(self.conv_final1(X))
        X = _gelu(self.conv_final2(X))
        return X if self.channels_last_io else X.transpose(-1, -2)
