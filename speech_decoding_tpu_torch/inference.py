"""Inference / serving API.

Port of ``speech_decoding_tpu/inference.py``:

  * ``encode`` — batched brain -> embedding encoding (eval mode);
  * ``retrieve`` — top-k candidate speech segments for each brain segment
    against the bank (cosine similarity, reference orientation
    [ref: models.py:226-243]);
  * ``decode`` — encode + retrieve in one call;
  * ``SpeechDecoder.decode_stream`` — sliding-window decoding of a
    continuous recording.

The default encode on the card is the fused serving path: SubjectBlock
(per-subject matmul kernel, its weights cast once like the fused blocks', so
the kernel's weight image is packed once) -> five fused ConvBlock kernels ->
two 1x1 GELU heads. ``use_fused_blocks=False`` runs the module forward
instead (which takes the same per-subject kernel).
The bank lives on the device. ``SpeechDecoder.from_checkpoint`` serves a
checkpoint of the port's ``training.CheckpointManager`` (the latest, the
best-model one or a given epoch). ``bank_from_audio`` and a sharded bank wait
for the wav2vec2 and parallel parts of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from speech_decoding_tpu_torch.ops.conv_block import apply_fused_stack, prepare_fused_stack
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul
from speech_decoding_tpu_torch.utils.device import resolve_device

ArrayLike = Union[np.ndarray, torch.Tensor]


def _unit_rows(Z: torch.Tensor) -> torch.Tensor:
    z = Z.float().reshape(Z.shape[0], -1)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-8)


def retrieve_topk(Z: torch.Tensor, bank_norm: torch.Tensor, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates per brain embedding: cosine similarity of flattened
    embeddings against the L2-normalized (N, F*T) bank rows. Returns
    (scores, ids), each (B, min(k, N)); ``k`` is clamped to the bank size."""
    sim = _unit_rows(Z) @ bank_norm.T
    return torch.topk(sim, min(int(k), bank_norm.shape[0]), dim=-1)


def quantize_rows_int8(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (q (N, D) int8, scale (N,) f32)
    with q * scale ~= rows."""
    scale = rows.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(rows / scale[:, None]).to(torch.int8)
    return q, scale.float()


def _int8_sim(zq: torch.Tensor, bank_q: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 dot products of int8-valued rows. On the card both operands
    are upcast to bf16 (exact for int8 values) and contracted with f32
    accumulation; the CPU has no bf16 x bf16 -> f32 product, so it contracts
    f32 copies, which is the same arithmetic."""
    if zq.is_cuda:
        return torch.mm(zq.to(torch.bfloat16), bank_q.to(torch.bfloat16).T, out_dtype=torch.float32)
    return zq.float() @ bank_q.float().T


def retrieve_topk_int8(Z: torch.Tensor, bank_q: torch.Tensor, bank_scale: torch.Tensor,
                       k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """``retrieve_topk`` against an int8-quantized bank: the query is
    row-quantized to int8 on the fly, the similarity contracts the int8
    values with f32 accumulation (no int32 overflow at any D) and is scaled
    back per row. bank_q (N, D) int8; bank_scale (N,) f32."""
    z = _unit_rows(Z)
    zscale = z.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    zq = torch.round(z / zscale).to(torch.int8)
    sim = _int8_sim(zq, bank_q) * zscale * bank_scale[None, :]
    return torch.topk(sim, min(int(k), bank_q.shape[0]), dim=-1)


class SpeechDecoder:
    """Serving wrapper around a trained ``BrainEncoder`` and a speech-segment
    bank Y_bank (N, F, T). Runs on ``device`` (default ``cuda``; raises when
    there is no GPU unless ``device="cpu"``)."""

    def __init__(
        self,
        encoder: BrainEncoder,
        bank: Optional[ArrayLike] = None,
        use_fused_blocks: Optional[bool] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.encoder = encoder.to(self.device).eval()
        if use_fused_blocks is None:
            use_fused_blocks = self.device.type == "cuda"
        self.use_fused_blocks = bool(use_fused_blocks)
        # BN folded and weights cast once: the fused stack reads them per call
        self._staged = (
            prepare_fused_stack(self.encoder.conv_blocks, self.encoder.compute_dtype)
            if self.use_fused_blocks else None
        )
        with torch.no_grad():
            self._subject_w = (
                self.encoder.subject_block.subject_kernel.detach().to(self.encoder.compute_dtype).contiguous()
                if self.use_fused_blocks else None
            )
        self._bank_norm: Optional[torch.Tensor] = None
        self._bank_q: Optional[torch.Tensor] = None
        self._bank_scale: Optional[torch.Tensor] = None
        if bank is not None:
            self.set_bank(bank)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, encoder: BrainEncoder, bank: Optional[ArrayLike] = None,
                        epoch: Optional[int] = None, best: bool = False,
                        device: Optional[Union[str, torch.device]] = None) -> "SpeechDecoder":
        """A decoder on ``encoder`` (built like the trained one) with the
        parameters and BatchNorm statistics of a checkpoint written by
        ``training.CheckpointManager`` in ``checkpoint_dir``: the latest, the
        given ``epoch``, or with ``best=True`` the best-model checkpoint of
        ``<checkpoint_dir>-best/``. The optimizer state is not read, so a
        MultiSteps checkpoint serves as well as an Adam one."""
        from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
        from speech_decoding_tpu_torch.training.state import create_train_state

        state = create_train_state(encoder, device=device)
        mgr = CheckpointManager(checkpoint_dir, track_metric="testTop10acc" if best else None)
        state, _ = mgr.restore_for_eval(state, epoch, best=best)
        return cls(state.encoder, bank, device=device)

    # -- serving ops ----------------------------------------------------------

    def _encode_fused(self, X: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        dt = enc.compute_dtype
        if not enc.channels_last_io:
            X = X.transpose(-1, -2)
        sb = enc.subject_block  # SubjectBlock.forward on the weights cast once
        h = subject_matmul(sb.conv(sb.spatial_attention(X.to(dt))).contiguous(), self._subject_w, sidx)
        h = apply_fused_stack(self._staged, h)
        for head in (enc.conv_final1, enc.conv_final2):
            h = Fn.gelu(head(h), approximate="none")
        return h if enc.channels_last_io else h.transpose(-1, -2)

    @property
    def bank_size(self) -> int:
        bank = self._bank_norm if self._bank_norm is not None else self._bank_q
        return 0 if bank is None else int(bank.shape[0])

    @torch.inference_mode()
    def set_bank(self, bank: ArrayLike, store_dtype: str = "float32") -> None:
        """Install the candidate speech-embedding bank, reference layout
        (N, F, T) [ref: models.py:226]; rows are L2-normalized once and kept
        on the device, f32 or per-row int8 (``store_dtype``).

        The flatten order must match ``encode``'s output layout: a
        channels-last encoder emits (B, T, F), so the bank is transposed to
        (N, T, F) before flattening. An (N, T, F) array passed here (e.g. a
        channels-last ``encode`` output) fails the feature-axis check and
        raises instead of silently mis-ranking."""
        nf = self.encoder.F
        if bank.ndim != 3 or bank.shape[1] != nf:
            hint = (
                " — an (N, T, F) array (e.g. a channels-last encode() "
                "output): swapaxes(bank, -1, -2) first"
                if bank.ndim == 3 and bank.shape[2] == nf
                else " — the bank's feature dim must equal the encoder's F"
            )
            raise ValueError(
                f"bank must be reference layout (N, F={nf}, T), got "
                f"{tuple(bank.shape)}{hint}"
            )
        if store_dtype not in ("float32", "int8"):
            raise ValueError(f"store_dtype must be float32 or int8, got {store_dtype}")
        self._bank_norm = self._bank_q = self._bank_scale = None
        flat = torch.as_tensor(bank).to(self.device, torch.float32)
        if self.encoder.channels_last_io:
            flat = flat.transpose(-1, -2)
        flat = flat.reshape(flat.shape[0], -1)
        bank_norm = flat / torch.linalg.vector_norm(flat, dim=-1, keepdim=True).clamp_min(1e-8)
        del flat
        if store_dtype == "int8":
            self._bank_q, self._bank_scale = quantize_rows_int8(bank_norm)
        else:
            self._bank_norm = bank_norm

    @torch.inference_mode()
    def encode(self, X: ArrayLike, subject_idxs: ArrayLike) -> torch.Tensor:
        """Brain segments (B, C, T) -> embeddings (B, F, T), eval mode (or
        (B, T, C) -> (B, T, F) for a channels-last encoder)."""
        if isinstance(subject_idxs, torch.Tensor):
            subject_idxs = subject_idxs.cpu()
        # host ids: the per-subject kernel's wrapper checks them on the host
        sidx = torch.from_numpy(np.asarray(subject_idxs, np.int32))
        X = torch.as_tensor(X).to(self.device, torch.float32)
        if self.use_fused_blocks:
            return self._encode_fused(X, sidx)
        return self.encoder(X, sidx)

    @torch.inference_mode()
    def retrieve(self, Z: torch.Tensor, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k bank candidates per brain embedding: (scores, ids), each (B, k)."""
        if self._bank_q is not None:
            return retrieve_topk_int8(Z, self._bank_q, self._bank_scale, k=k)
        if self._bank_norm is None:
            raise RuntimeError("call set_bank() first")
        return retrieve_topk(Z, self._bank_norm, k=k)

    def decode(self, X: ArrayLike, subject_idxs: ArrayLike, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """encode + retrieve: numpy (scores (B, k) f32, ids (B, k) int32)."""
        scores, ids = self.retrieve(self.encode(X, subject_idxs), k)
        return scores.cpu().numpy(), ids.to(torch.int32).cpu().numpy()

    def decode_stream(
        self,
        X: np.ndarray,
        subject_idx: int,
        segment_len: int,
        hop: Optional[int] = None,
        k: int = 10,
        batch_size: int = 64,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sliding-window decoding of one CONTINUOUS recording.

        ``X`` is the preprocessed recording — (C, T_total), or (T_total, C)
        when the encoder is channels-last — windowed into segments of
        ``segment_len`` samples every ``hop`` samples (default: segment_len,
        non-overlapping) and batch-decoded against the bank. Returns
        (scores (W, k), ids (W, k), onsets (W,) in samples). The final
        partial batch is zero-padded to ``batch_size`` so every dispatch has
        one shape, then trimmed."""
        if self._bank_norm is None and self._bank_q is None:
            raise RuntimeError("call set_bank() first")
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"one continuous recording expected, got {X.shape}")
        time_axis = 0 if self.encoder.channels_last_io else 1
        total = X.shape[time_axis]
        hop = segment_len if hop is None else int(hop)
        if hop < 1 or total < segment_len:
            raise ValueError(f"need hop >= 1 and a recording of >= {segment_len} samples, got hop={hop}, {total}")
        onsets = np.arange(0, total - segment_len + 1, hop)

        def window(o):
            return X[o : o + segment_len] if time_axis == 0 else X[:, o : o + segment_len]

        scores, ids = [], []
        sidx = np.full((batch_size,), subject_idx, np.int32)
        # windows are materialized one batch at a time
        for i in range(0, len(onsets), batch_size):
            chunk = onsets[i : i + batch_size]
            w = np.stack([window(o) for o in chunk])
            pad = batch_size - w.shape[0]
            if pad:
                w = np.concatenate([w, np.zeros((pad,) + w.shape[1:], w.dtype)])
            s, t = self.decode(w, sidx, k)
            scores.append(s[: batch_size - pad])
            ids.append(t[: batch_size - pad])
        return np.concatenate(scores), np.concatenate(ids), onsets
