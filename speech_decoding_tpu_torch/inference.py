"""Inference / serving API.

Port of ``speech_decoding_tpu/inference.py``:

  * ``encode`` — batched brain -> embedding encoding (eval mode);
  * ``retrieve`` — top-k candidate speech segments for each brain segment
    against the bank (cosine similarity, reference orientation
    [ref: models.py:226-243]);
  * ``decode`` — encode + retrieve in one call;
  * ``bank_from_audio`` — build the candidate bank directly from raw audio
    clips with the port's wav2vec2 (the training audio pipeline's embed chain
    [ref: dataclass/gwilliams2022.py:327-387] as a serving op);
  * ``SpeechDecoder.decode_stream`` — sliding-window decoding of a
    continuous recording.

The default encode on the card is the fused serving path: SubjectBlock
(per-subject matmul kernel, its weights cast once like the fused blocks', so
the kernel's weight image is packed once) -> five fused ConvBlock kernels ->
two 1x1 GELU heads. ``use_fused_blocks=False`` runs the module forward
instead (which takes the same per-subject kernel).
The bank lives on the device. ``SpeechDecoder.from_checkpoint`` serves a
checkpoint of the port's ``training.CheckpointManager`` (the latest, the
best-model one or a given epoch).

``set_bank(..., group=)`` is JAX's ``set_bank(mesh=)``: a bank larger than
one card's memory held as row blocks, one a rank (``parallel.DataGroup``;
one process a card). Each rank scores its block, and an all-gather of the
(B, k) winners is merged on every rank, so every rank returns the same
answer and each encodes the same request.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from speech_decoding_tpu_torch.ops.conv_block import apply_fused_stack, prepare_fused_stack
from speech_decoding_tpu_torch.ops.resample import fft_resample, sinc_resample
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul
from speech_decoding_tpu_torch.parallel.collectives import all_gather_stack
from speech_decoding_tpu_torch.parallel.mesh import DataGroup
from speech_decoding_tpu_torch.utils.device import resolve_device

ArrayLike = Union[np.ndarray, torch.Tensor]

_BANK_CHUNK_BYTES = 1 << 28  # bank rows set_bank normalizes (f32) and an int8 decode upcasts (bf16) at a time


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


def quantize_query_int8(Z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unit-normalized, flattened query rows quantized per row as the
    bank's are: (zq (B, D) int8, zscale (B, 1) f32)."""
    z = _unit_rows(Z)
    zscale = z.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(z / zscale).to(torch.int8), zscale


def _int8_sim(zq: torch.Tensor, bank_q: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 dot products of int8-valued rows. On the card both operands
    are upcast to bf16 (exact for int8 values), a chunk of bank rows at a
    time so the bank is never copied whole, and contracted with f32
    accumulation; the CPU has no bf16 x bf16 -> f32 product, so it contracts
    f32 copies, which is the same arithmetic."""
    if not zq.is_cuda:
        return zq.float() @ bank_q.float().T
    z = zq.to(torch.bfloat16)
    sim = torch.empty((zq.shape[0], bank_q.shape[0]), dtype=torch.float32, device=zq.device)
    step = max(1, _BANK_CHUNK_BYTES // (2 * bank_q.shape[1]))
    for i in range(0, bank_q.shape[0], step):
        sim[:, i : i + step] = torch.mm(z, bank_q[i : i + step].to(torch.bfloat16).T, out_dtype=torch.float32)
    return sim


def retrieve_topk_int8(Z: torch.Tensor, bank_q: torch.Tensor, bank_scale: torch.Tensor,
                       k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """``retrieve_topk`` against an int8-quantized bank: the query is
    row-quantized to int8 on the fly, the similarity contracts the int8
    values with f32 accumulation (no int32 overflow at any D) and is scaled
    back per row. bank_q (N, D) int8; bank_scale (N,) f32."""
    zq, zscale = quantize_query_int8(Z)
    sim = _int8_sim(zq, bank_q) * zscale * bank_scale[None, :]
    return torch.topk(sim, min(int(k), bank_q.shape[0]), dim=-1)


@torch.inference_mode()
def bank_from_audio(
    wav2vec,
    waveforms: np.ndarray,
    sample_rate: int,
    segment_len: int,
    brain_rate: float = 120.0,
    audio_rate: int = 16000,
    lowpass_filter_width: int = 6,
    batch_size: int = 16,
    last4layers: bool = True,
) -> torch.Tensor:
    """Raw candidate audio clips -> a (N, F, segment_len) f32 retrieval bank
    on the embedder's device.

    Runs the training audio pipeline's embed chain per clip
    [ref: dataclass/gwilliams2022.py:327-387]: windowed-sinc resample to
    ``audio_rate`` -> wav2vec2 last-4-layer mean (or the conv
    feature-extractor path when ``last4layers=False``, mirroring the
    ``preprocs.last4layers`` training flag [ref: brennan2018.py:187-189]) ->
    FFT resample from the model's realized frame rate to ``brain_rate`` ->
    crop/zero-pad to ``segment_len``. The result goes straight into
    ``SpeechDecoder.set_bank`` (reference (N, F, T) layout
    [ref: models.py:226]); its feature dim must match the encoder's F.

    ``waveforms`` is (N, L) mono f32, all clips the same length; the clip
    count is zero-padded to a ``batch_size`` multiple so every forward has
    one shape (embedding is per-sample independent; padded rows are
    dropped). ``wav2vec`` is a ``models.wav2vec_util.FrozenWav2Vec2``.

    The training pipeline embeds the CONTINUOUS stimulus and slices segments
    out of the embedding; per-clip embedding differs slightly near clip
    edges (the conv extractor's receptive field)."""
    waveforms = np.asarray(waveforms, np.float32)
    if waveforms.ndim != 2:
        raise ValueError(f"(N, L) mono clips expected, got {waveforms.shape}")
    n = waveforms.shape[0]
    if n % batch_size:
        pad_rows = batch_size - n % batch_size
        waveforms = np.concatenate(
            [waveforms, np.zeros((pad_rows, waveforms.shape[1]), np.float32)]
        )
    outs = []
    for i in range(0, waveforms.shape[0], batch_size):
        wav = torch.from_numpy(waveforms[i : i + batch_size]).to(wav2vec.device)
        if sample_rate != audio_rate:
            wav = sinc_resample(wav, sample_rate, audio_rate, lowpass_filter_width=lowpass_filter_width)
        emb = wav2vec.last4_mean(wav) if last4layers else wav2vec.features(wav)
        emb = emb.transpose(-1, -2)  # (b, F, T_emb)
        # frame rate of the embedding, from realized lengths (the conv
        # extractor's stride product is not exactly 320 at every length)
        rate_after = audio_rate * emb.shape[-1] / wav.shape[-1]
        emb = fft_resample(emb, up=float(brain_rate) / rate_after)
        t = emb.shape[-1]
        emb = emb[..., :segment_len] if t >= segment_len else Fn.pad(emb, (0, segment_len - t))
        outs.append(emb)
    return torch.cat(outs)[:n]


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
        self._bank_group: Optional[DataGroup] = None
        self._bank_rows = 0  # the whole bank's N (this rank holds a block of it under a group)
        self._bank_offset = 0  # the global id of this rank's first row
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
        """N of the whole bank (every rank's block together under a group)."""
        return self._bank_rows

    @torch.inference_mode()
    def set_bank(self, bank: ArrayLike, store_dtype: str = "float32", group: Optional[DataGroup] = None) -> None:
        """Install the candidate speech-embedding bank, reference layout
        (N, F, T) [ref: models.py:226]; rows are L2-normalized once and kept
        on the device, f32 or per-row int8 (``store_dtype``).

        ``group``: every rank passes the same whole bank and keeps only its
        row block (``group.block(N)``; N must divide by the ranks, as JAX's
        row sharding requires). A host bank (numpy or a CPU tensor) is
        sliced before its block is copied to the device, so no rank holds
        the whole bank there; normalization and quantization are per row,
        so each block's rows are the one-process bank's.

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
        rows = torch.as_tensor(bank)
        blk = slice(0, None) if group is None else group.block(rows.shape[0])  # raises unless N divides by W
        self._bank_norm = self._bank_q = self._bank_scale = None
        self._bank_group, self._bank_rows, self._bank_offset = group, int(rows.shape[0]), blk.start
        block = rows[blk]
        n, d = block.shape[0], block.shape[1] * block.shape[2]
        # normalized (and quantized) a chunk of rows at a time straight into
        # the stored bank, so the device holds little beyond the stored rows
        if store_dtype == "int8":
            self._bank_q = torch.empty((n, d), dtype=torch.int8, device=self.device)
            self._bank_scale = torch.empty((n,), dtype=torch.float32, device=self.device)
        else:
            self._bank_norm = torch.empty((n, d), dtype=torch.float32, device=self.device)
        step = max(1, _BANK_CHUNK_BYTES // (4 * d))
        for i in range(0, n, step):
            flat = block[i : i + step].to(self.device, torch.float32)
            if self.encoder.channels_last_io:
                flat = flat.transpose(-1, -2)
            unit = _unit_rows(flat)
            if store_dtype == "int8":
                self._bank_q[i : i + step], self._bank_scale[i : i + step] = quantize_rows_int8(unit)
            else:
                self._bank_norm[i : i + step] = unit

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
        """Top-k bank candidates per brain embedding: (scores, ids), each (B,
        min(k, N)). Under a group each rank takes the top-k of its block,
        the (B, k) scores and global ids of every rank are gathered, and one
        top-k over them gives every rank the same answer."""
        if self._bank_q is not None:
            scores, ids = retrieve_topk_int8(Z, self._bank_q, self._bank_scale, k=k)
        elif self._bank_norm is not None:
            scores, ids = retrieve_topk(Z, self._bank_norm, k=k)
        else:
            raise RuntimeError("call set_bank() first")
        group = self._bank_group
        if group is None:
            return scores, ids
        # (W, B, k_block) -> (B, W·k_block), in rank order: global ids ascending between blocks
        scores = all_gather_stack(scores, group).transpose(0, 1).flatten(1)
        ids = all_gather_stack(ids + self._bank_offset, group).transpose(0, 1).flatten(1)
        best, pos = torch.topk(scores, min(int(k), self._bank_rows), dim=-1)
        return best, torch.gather(ids, 1, pos)

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
