"""Frozen wav2vec2 embedding helpers.

Port of ``speech_decoding_tpu/models/wav2vec_util.py``, which re-implements
the reference's wav2vec_util [ref: speech_decoding/utils/wav2vec_util.py:8-32]:
load the (frozen) model and produce per-frame embeddings as the average of
the last four hidden layers, computed over 10 splits of the waveform —
including the reference's chunk-boundary artifact, reproduced for parity
[ref: wav2vec_util.py:23-24 FIXME].
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from speech_decoding_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2Model,
    extract_features,
    model_from_torch,
)
from speech_decoding_tpu_torch.utils.device import resolve_device
from speech_decoding_tpu_torch.utils.logging import cprint


class FrozenWav2Vec2:
    """A ``Wav2Vec2Model`` frozen on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``) in ``dtype`` — the model is moved
    and cast in place — with the two embedding entry points. Both take a
    (B, T) waveform (numpy or tensor), run under ``torch.inference_mode()``
    and return f32 tensors on the device."""

    def __init__(self, model: Wav2Vec2Model, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cfg: Wav2Vec2Config = model.cfg
        self.model = model.to(self.device, dtype).eval().requires_grad_(False)

    def _input(self, waveform) -> torch.Tensor:
        return torch.as_tensor(waveform).to(self.device, self.dtype)

    @torch.inference_mode()
    def last4_mean(self, waveform) -> torch.Tensor:
        """(B, T) -> (B, T', hidden): mean of the last 4 hidden layers
        [ref: wav2vec_util.py:17-20], taken in f32."""
        _, hidden = self.model(self._input(waveform), output_hidden_states=True)
        return torch.stack(hidden[-4:]).float().mean(0)

    @torch.inference_mode()
    def features(self, waveform) -> torch.Tensor:
        """(B, T) -> (B, T', 512) conv feature-extractor path."""
        return extract_features(self.model, self._input(waveform)).float()


def load_wav2vec_model(
    name_or_path: str = "facebook/wav2vec2-large-xlsr-53",
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.float32,
) -> FrozenWav2Vec2:
    """Load pretrained weights [ref: wav2vec_util.py:8-11] from local files
    only; nothing is downloaded.

    A ``.safetensors`` file (or a directory holding ``model.safetensors``)
    loads through ``models.wav2vec2_safetensors``. Otherwise, if
    ``transformers`` imports, its ``from_pretrained`` reads the local cache
    or a local directory (``local_files_only=True``). A checkpoint that is
    not on disk raises with instructions."""
    st_path = None
    if name_or_path.endswith(".safetensors") and os.path.exists(name_or_path):
        st_path = name_or_path
    elif os.path.isdir(name_or_path) and os.path.exists(
        os.path.join(name_or_path, "model.safetensors")
    ):
        st_path = os.path.join(name_or_path, "model.safetensors")
    if st_path is not None:
        from speech_decoding_tpu_torch.models.wav2vec2_safetensors import load_safetensors_params

        cprint(f"Loading wav2vec2 weights from {st_path}", "cyan")
        return FrozenWav2Vec2(load_safetensors_params(st_path), device, dtype)
    try:
        import transformers

        cprint("Loading HuggingFace Wav2Vec2.0 weights from local files", "cyan")
        hf = transformers.Wav2Vec2Model.from_pretrained(name_or_path, local_files_only=True)
    except Exception as e:  # ImportError, or no local checkpoint: one message for both
        raise RuntimeError(
            f"Could not load wav2vec2 weights for {name_or_path!r} "
            f"(offline environment?): {e}. Provide a local checkpoint "
            "directory via config wav2vec_model=<path>."
        ) from e
    hc = hf.config
    cfg = Wav2Vec2Config(
        conv_dim=tuple(hc.conv_dim),
        conv_stride=tuple(hc.conv_stride),
        conv_kernel=tuple(hc.conv_kernel),
        conv_bias=hc.conv_bias,
        feat_extract_norm=hc.feat_extract_norm,
        hidden_size=hc.hidden_size,
        num_hidden_layers=hc.num_hidden_layers,
        num_attention_heads=hc.num_attention_heads,
        intermediate_size=hc.intermediate_size,
        num_conv_pos_embeddings=hc.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=hc.num_conv_pos_embedding_groups,
        do_stable_layer_norm=hc.do_stable_layer_norm,
        layer_norm_eps=hc.layer_norm_eps,
    )
    return FrozenWav2Vec2(model_from_torch(hf.state_dict(), cfg), device, dtype)


def embed_waveform(
    wav2vec: FrozenWav2Vec2, waveform: np.ndarray, last4layers: bool = True
) -> np.ndarray:
    """(T,) mono waveform -> (F, T_emb) f32 numpy embeddings.

    last4layers: split the waveform into 10 chunks, embed each, average the
    last four hidden layers, concatenate along time — reproducing the
    reference's chunking (and its boundary artifact)
    [ref: wav2vec_util.py:14-32]. Otherwise the conv feature-extractor path
    (F=512) [ref: brennan2018.py:187-189]."""
    if wav2vec is None:
        raise ValueError("a FrozenWav2Vec2 (or compatible) is required")
    waveform = np.asarray(waveform, np.float32).reshape(-1)
    if not last4layers:
        return wav2vec.features(waveform[None])[0].T.cpu().numpy()
    # np.array_split yields at most TWO distinct chunk lengths (q+1 x r then
    # q x (10-r)), so the reference's 10 sequential forwards batch into <= 2
    # forwards of equal-length chunks (each output row is an independent
    # per-sample compute; chunk boundaries — and the artifact — are unchanged)
    bounds = np.array_split(np.arange(waveform.shape[-1]), 10)
    sizes = [len(b) for b in bounds]
    outs: list = [None] * len(bounds)
    for size in sorted(set(sizes), reverse=True):
        idxs = [i for i, s in enumerate(sizes) if s == size]
        batch = np.stack([waveform[bounds[i][0] : bounds[i][-1] + 1] for i in idxs])
        emb = wav2vec.last4_mean(batch).cpu().numpy()  # (b, T', F)
        for j, i in enumerate(idxs):
            outs[i] = emb[j]
    return np.concatenate(outs, axis=0).T  # (F, T_emb)
