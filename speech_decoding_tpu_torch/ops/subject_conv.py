"""Per-subject 1x1 conv: ``out[b] = x[b] @ W[subject_idxs[b]]``.

Port of ``speech_decoding_tpu/ops/pallas/subject_conv.py`` (K1). The
SubjectBlock applies a different (D1, D1) matrix to each batch row, selected
by subject id [ref: speech_decoding/models.py:98-116]. The CUDA kernels
(``csrc/subject_matmul.cu``) read each row's subject id inside the thread
block and take that subject's weights, so no gathered (B, D1, D1) copy
exists.

``subject_matmul`` is differentiable, as the JAX ``custom_vjp`` is: dX is
the same product on g and Wᵀ (so a train step launches it twice), dW the
per-row xᵀg in f32 summed by subject (``torch.bmm`` + ``index_add_``; JAX
leaves this to XLA's ``segment_sum``, so it stays a stock op here), cast to
W's dtype.

Routes on the card (``subject_matmul.route`` names the last one taken):
  * ``"wgmma"``: bf16 products inside ``_fast_path`` (the flagship's 270 →
    270 at any B, forward and dX), on Hopper's ``wgmma``. x (or g) is read
    where it lies, one bulk copy of contiguous rows a 64-row tile, which
    needs a 16-byte aligned base and T·D_in % 8 == 0 (rows of 540 bytes
    start 16-byte aligned every 4 rows); the output leaves the same way.
    The weights reach the kernel as a 272 × 272 image of 8 × 8 core
    matrices, zero-padded (``pack_weights``, made on the card by one launch
    of a small pack kernel, the dX's straight from W, transposed as it is
    read). The image is cached on the weight's identity (the tensor object,
    its ``_version``, pointer, shape and dtype): a decoder whose weights
    stay put packs once, a train step once a direction.
  * ``"wmma"``: every other bf16 product (ragged shapes, odd widths, more
    than 272 channels, a misaligned base, which is copied first), on the
    warp-level mma body.
  * ``"f32"``: f32 products, on the CUDA cores.

``subject_matmul`` launches a kernel for CUDA tensors and uses
``subject_matmul_plain`` for CPU tensors; it never falls back on the card.
Subject ids may lie on the host: they are checked there (one pass of numpy
over the ids) and copied to the card from a pinned ring without a wait, so
a later change of the host array does not reach the launch (the serving
encode and the train step pass them so). Ids on the card are checked there,
which costs one wait for the card. The backward reuses the checked copy.

While the current stream captures a CUDA graph (``training/steps.py``'s
replayed step), K1 takes its ids on the card, from a buffer the caller
fills and checks before each replay: it neither checks them (a wait cannot
be captured) nor stages host ids (the captured copy would read the same
host address at every replay), and ``packed_weights`` neither reads nor
writes its cache (the image is made by the captured pack launch).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import INT, PTR

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
LIB = _build.Library("subject_matmul", {
    "subject_matmul_f32": [PTR] * 5 + [INT] * 4,
    "subject_matmul_bf16": [PTR] * 5 + [INT] * 4,
    "subject_matmul_wg_bf16": [PTR] * 5 + [INT] * 5,
    "subject_matmul_pack_bf16": [PTR] * 2 + [INT] * 4,
})
WG_CHANNELS = 272  # weight image: 272 output channels (two wgmma n=136 halves), 272 deep
_STEPS = WG_CHANNELS // 16  # 16-deep reduction steps of the image


def _fast_path(B: int, T: int, Din: int, Dout: int, x_ptr: int) -> bool:
    """Whether a bf16 product of x (B, T, Din) at address ``x_ptr`` with
    (Din, Dout) weights takes the ``wgmma`` body: every 64-row tile of x and
    of the output one contiguous run of whole 16-byte pieces at a 16-byte
    aligned start (T·Din % 8 == 0, T·Dout % 8 == 0, x's base aligned; the
    output is allocated aligned), rows of 4-byte column pairs (Din and Dout
    even), and Din, Dout <= 272."""
    return (B * T > 0 and 0 < Din <= WG_CHANNELS and Din % 2 == 0 and 0 < Dout <= WG_CHANNELS
            and Dout % 2 == 0 and (T * Din) % 8 == 0 and (T * Dout) % 8 == 0 and x_ptr % 16 == 0)


def pack_weights(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """The ``wgmma`` body's weight image of w (S, K, N) (with ``transposed``,
    of w.transpose(1, 2): the dX's Wᵀ), K, N <= 272: (S, 17, 34, 2, 8, 8)
    with ``[s, j, g, h, r, e] = w[s, 16j + 8h + e, 8g + r]``, zero past K
    and N: the 272 × 272 padded weights as 8 × 8 core matrices (128
    contiguous bytes each), one contiguous piece a 16-deep reduction step.
    The plain version of the pack kernel (the CPU tests hold it against
    ``Fn.pad``)."""
    wk = w.transpose(1, 2) if transposed else w
    S, K, N = wk.shape
    if K > WG_CHANNELS or N > WG_CHANNELS:
        raise ValueError(f"the weight image holds at most {WG_CHANNELS} x {WG_CHANNELS}, got {K} x {N}")
    p = Fn.pad(wk, (0, WG_CHANNELS - N, 0, WG_CHANNELS - K))
    return p.reshape(S, _STEPS, 2, 8, WG_CHANNELS // 8, 8).permute(0, 1, 4, 2, 5, 3).contiguous()


_packs = {}  # transposed -> (weakref to w, _version, data_ptr, shape, dtype, image): the last pack a direction


def packed_weights(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """``pack_weights(w, transposed)``, made once for a weight that stays put:
    the last image of each direction is kept while the same tensor object
    has the same ``_version``, pointer, shape and dtype (an in-place update
    or a new tensor packs again; inference tensors, which keep no version,
    always pack; under graph capture the cache is left alone). On the card
    one launch of the pack kernel (counted in ``packed_weights.packs``); on
    the CPU the plain version."""
    capturing = w.is_cuda and torch.cuda.is_current_stream_capturing()
    hit = None if capturing else _packs.get(transposed)
    inference = w.is_inference()
    if (hit is not None and not inference and hit[0]() is w and hit[1] == w._version
            and hit[2:5] == (w.data_ptr(), w.shape, w.dtype)):
        return hit[5]
    if w.is_cuda:
        if w.dtype != torch.bfloat16 or not w.is_contiguous():
            raise ValueError("the pack kernel takes contiguous bfloat16 weights")
        S, K, N = (w.shape[0], w.shape[2], w.shape[1]) if transposed else w.shape
        if not (0 < K <= WG_CHANNELS and 0 < N <= WG_CHANNELS):
            raise ValueError(f"the weight image takes K, N <= {WG_CHANNELS}, got {K}, {N}")
        img = w.new_empty((S, _STEPS, WG_CHANNELS // 8, 2, 8, 8))
        LIB("subject_matmul_pack_bf16", w.get_device(), w, img, S, K, N, int(transposed))
        packed_weights.packs += 1
    else:
        img = pack_weights(w, transposed)
    if not (inference or capturing):
        _packs[transposed] = (weakref.ref(w), w._version, w.data_ptr(), w.shape, w.dtype, img)
    return img


packed_weights.packs = 0  # pack-kernel launches (CUDA tensors only)


def subject_matmul_plain(x: torch.Tensor, w: torch.Tensor, subject_idxs: torch.Tensor) -> torch.Tensor:
    """Reference: einsum over the gathered weights, f32 accumulation, output
    in x's dtype. x (B, T, Din); w (S, Din, Dout); subject_idxs (B,) int."""
    wg = w[subject_idxs.long()]
    return torch.einsum("bti,bio->bto", x.float(), wg.float()).to(x.dtype)


def _check_ids(subject_idxs: torch.Tensor, num_subjects: int) -> None:
    # the Pallas index map would read out of bounds silently; raise instead
    # (ids on the card cost one wait for the card)
    if subject_idxs.numel() and bool(((subject_idxs < 0) | (subject_idxs >= num_subjects)).any()):
        raise ValueError(
            f"subject ids must lie in [0, {num_subjects}), got "
            f"[{int(subject_idxs.min())}, {int(subject_idxs.max())}]"
        )


def check_host_ids(ids: np.ndarray, num_subjects: int) -> None:
    # one pass: a negative id reads as a huge unsigned one
    if ids.size and bool((ids.view(f"u{ids.itemsize}") >= num_subjects).any()):
        raise ValueError(f"subject ids must lie in [0, {num_subjects}), got [{ids.min()}, {ids.max()}]")


class _PinnedIds:
    """A pinned host ring the ids cross to the card from. Each call writes its
    ids into the next free run of the ring, and the launch's C entry copies
    that run to the card (``cudaMemcpyAsync`` on the launch's stream, just
    before the kernel), so the host array may change as soon as the call
    returns and no call waits for the card. The ring is cut into SEGMENTS;
    as the writer leaves a segment it records an event on each stream that
    copied from it, and it waits for those events when it comes back a lap
    later, by which time the card has long run those copies."""

    SEGMENTS, SEGMENT = 4, 1 << 14  # int32 ids

    def __init__(self):
        self._lock = threading.Lock()
        self._buf = self._np = None
        self._streams = [set() for _ in range(self.SEGMENTS)]  # (device, stream address) that copied
        self._events = [[] for _ in range(self.SEGMENTS)]
        self._seg = self._off = 0

    def stage(self, ids: np.ndarray, device: int, stream: int) -> int:
        """The host address of a pinned int32 copy of ``ids`` (at most SEGMENT
        of them), which ``stream`` of ``device`` is about to copy."""
        n = ids.size
        with self._lock:
            if self._buf is None:
                self._buf = torch.empty(self.SEGMENTS * self.SEGMENT, dtype=torch.int32, pin_memory=True)
                self._np = self._buf.numpy()
            if self._off + n > self.SEGMENT:  # leave this segment, enter the next
                seg = self._seg
                self._events[seg] = [torch.cuda.ExternalStream(s, device=d).record_event()
                                     for d, s in self._streams[seg]]
                self._streams[seg].clear()
                self._seg, self._off = (seg + 1) % self.SEGMENTS, 0
                for event in self._events[self._seg]:
                    event.synchronize()
            self._streams[self._seg].add((device, stream))
            start = self._seg * self.SEGMENT + self._off
            self._off += n
            self._np[start : start + n] = ids
            return self._buf.data_ptr() + 4 * start


_pinned_ids = _PinnedIds()


def _launch(x: torch.Tensor, w: torch.Tensor, sidx: torch.Tensor, transposed: bool, host_ids: int = 0) -> torch.Tensor:
    """The product on the card. ``host_ids``: the address of pinned host ids
    that the launch copies into ``sidx`` first (0: ``sidx`` holds them)."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"subject_matmul takes float32 or bfloat16 x and w of one dtype, got {x.dtype}, {w.dtype}")
    if sidx.dtype != torch.int32:
        raise TypeError(f"subject ids must be int32 on the card, got {sidx.dtype}")
    dev = x.get_device()
    if not w.get_device() == sidx.get_device() == dev:
        raise ValueError("subject_matmul: x, w and subject_idxs must lie on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous() and sidx.is_contiguous()):
        raise ValueError("subject_matmul takes contiguous tensors")
    B, T, Din = x.shape
    Dout = w.shape[1] if transposed else w.shape[2]
    out = x.new_empty((B, T, Dout))
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16 and _fast_path(B, T, Din, Dout, x.data_ptr()):
        route = "wgmma"
        img = packed_weights(w, transposed)
        LIB("subject_matmul_wg_bf16", dev, x, img, sidx, host_ids, out, B, T, Din, Dout, _build.sms(x.device))
    else:
        route = "wmma" if x.dtype == torch.bfloat16 else "f32"
        wk = w.transpose(1, 2).contiguous() if transposed else w
        # the body copies tiles in 16-byte pieces: realign a tensor that starts mid-allocation
        x, wk = (t.clone() if t.data_ptr() % 16 else t for t in (x, wk))
        LIB(f"subject_matmul_{_DTYPES[x.dtype]}", dev, x, wk, sidx, host_ids, out, B, T, Din, Dout)
    subject_matmul.launches += 1
    subject_matmul.route = route
    return out


def _apply(x: torch.Tensor, w: torch.Tensor, sidx: torch.Tensor, transposed: bool = False,
           host_ids: int = 0) -> torch.Tensor:
    """x @ W[sidx] (with ``transposed``, x @ Wᵀ[sidx], W read in place on the card)."""
    if x.is_cuda:
        return _launch(x, w, sidx, transposed, host_ids)
    return subject_matmul_plain(x, w.transpose(1, 2) if transposed else w, sidx)


class _SubjectMatmul(torch.autograd.Function):
    """Checked ids on x's device in; the JAX ``_fwd``/``_bwd`` pair."""

    @staticmethod
    def forward(ctx, x, w, sidx, host_ids):
        ctx.save_for_backward(x, w, sidx)
        return _apply(x, w, sidx, False, host_ids)

    @staticmethod
    def backward(ctx, g):
        x, w, sidx = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _apply(g.to(x.dtype).contiguous(), w, sidx, transposed=True)
        if ctx.needs_input_grad[1]:
            per_row = torch.bmm(x.float().transpose(1, 2), g.float())  # (B, Din, Dout)
            dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            dw = dw.index_add_(0, sidx.long(), per_row).to(w.dtype)
        return dx, dw, None, None


def subject_matmul(x: torch.Tensor, w: torch.Tensor, subject_idxs: torch.Tensor) -> torch.Tensor:
    """out[b] = x[b] @ w[subject_idxs[b]]: x (B, T, Din), w (S, Din, Dout),
    subject_idxs (B,), on x's device or on the host. Differentiable in x and
    w. Raises ValueError for an id outside [0, S) (under graph capture the
    caller checks them: module docstring)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"subject_matmul shapes: x (B, T, Din), w (S, Din, Dout); got {tuple(x.shape)}, {tuple(w.shape)}")
    if subject_idxs.shape != (x.shape[0],):
        raise ValueError(f"subject_idxs must be ({x.shape[0]},), got {tuple(subject_idxs.shape)}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"subject_matmul runs on CUDA or CPU tensors, got {x.device}")
    host_ids = 0
    capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
    if subject_idxs.device.type == "cpu":
        if capturing:
            raise ValueError("under CUDA graph capture subject_matmul takes its ids on the card, checked by the caller")
        ids = subject_idxs.numpy()
        check_host_ids(ids, w.shape[0])
        sidx = subject_idxs
        if x.is_cuda:  # filled by the launch from the pinned ring (by a plain copy if nothing launches)
            if x.numel() and w.shape[2] and ids.size <= _PinnedIds.SEGMENT:
                sidx = x.new_empty(ids.shape, dtype=torch.int32)
                dev = x.get_device()
                host_ids = _pinned_ids.stage(ids, dev, _build.current_stream(dev))
            else:
                sidx = subject_idxs.to(x.device, torch.int32)
    else:
        if not capturing:
            _check_ids(subject_idxs, w.shape[0])
        sidx = subject_idxs.to(x.device)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _SubjectMatmul.apply(x, w, sidx, host_ids)
    return _apply(x, w, sidx, False, host_ids)


subject_matmul.launches = 0  # kernel launches (CUDA tensors only)
subject_matmul.route = None  # the body the last launch took: "wgmma", "wmma" or "f32"
