"""Torch-free reading of HF ``model.safetensors`` files, into the port's
wav2vec2 module.

Port of ``speech_decoding_tpu/models/wav2vec2_safetensors.py``: the
from-spec parser, ``infer_config`` and ``config_from_json`` are numpy and
are copied unchanged (a single ``model.safetensors`` file plus optionally
its ``config.json`` is enough; the ``safetensors`` package is not needed);
``load_safetensors_params`` returns the port's ``Wav2Vec2Model``.

Key handling:
  * ``wav2vec2.``-prefixed checkpoints (Wav2Vec2ForCTC / ForPreTraining
    exports) are un-prefixed automatically;
  * extra heads (quantizer, project_q, lm_head, masked_spec_embed, ...) are
    ignored — only the bare-Wav2Vec2Model subtree is read;
  * both weight-norm layouts of the positional conv (legacy weight_g/v and
    the parametrizations.* form) are accepted (same as params_from_torch).

Config: pass an explicit ``Wav2Vec2Config``, a ``config.json`` path/dict, or
let ``infer_config`` derive it from tensor shapes (everything is inferable
except the head count and conv strides, which follow the published wav2vec2
family conventions and can be overridden).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, model_from_torch

__all__ = ["read_safetensors", "infer_config", "config_from_json", "load_safetensors_params"]

# published family conventions for fields tensor shapes cannot determine
_HEADS_BY_WIDTH = {768: 12, 1024: 16, 1280: 16}
_STANDARD_STRIDES = (5, 2, 2, 2, 2, 2, 2)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into {name: numpy array}, stripping a
    ``wav2vec2.`` prefix when present (ForCTC/ForPreTraining exports).

    From-spec parser, zero dependencies (so ``pip install
    speech-decoding-tpu`` + one .safetensors file really is enough — the
    ``safetensors`` package is NOT a core dependency). Format
    (https://github.com/huggingface/safetensors#format): little-endian u64
    header length, a JSON header mapping tensor name ->
    {dtype, shape, data_offsets} (offsets relative to the end of the
    header), then the raw buffers. Parity with ``safetensors.numpy`` is
    tested across every dtype including bf16 (tests/test_wav2vec2.py)."""
    raw = _parse_safetensors(path)
    if any(k.startswith("wav2vec2.") for k in raw):
        raw = {
            k[len("wav2vec2.") :]: v for k, v in raw.items() if k.startswith("wav2vec2.")
        }
    return raw


# safetensors dtype tag -> numpy. BF16 has no numpy dtype: read the raw u16
# payload and widen to f32 by shifting into the high mantissa/exponent bits.
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def _parse_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Streamed per-tensor reads: peak memory is the decoded tensors plus one
    tensor's transient copy (never 2x the whole file), every offset/size is
    validated so a truncated download raises a named error instead of an
    opaque numpy reshape failure, and the returned arrays are writable
    native-endian copies (like ``safetensors.numpy.load_file``)."""
    fsize = os.path.getsize(path)
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        hlen = int.from_bytes(head, "little")
        if 8 + hlen > fsize:
            raise ValueError(f"{path}: header length {hlen} exceeds file size")
        header = json.loads(f.read(hlen).decode("utf-8"))
        base = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            shape = tuple(meta["shape"])
            tag = meta["dtype"]
            if tag == "BF16":
                itemsize = 2
            elif tag in _ST_DTYPES:
                itemsize = np.dtype(_ST_DTYPES[tag]).itemsize
            else:
                raise ValueError(
                    f"{path}: unsupported safetensors dtype {tag} for {name}"
                )
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if not (0 <= start <= end) or base + end > fsize:
                raise ValueError(
                    f"{path}: tensor {name!r} data_offsets {(start, end)} out of "
                    f"bounds for file size {fsize} (truncated download?)"
                )
            if end - start != count * itemsize:
                raise ValueError(
                    f"{path}: tensor {name!r} has {end - start} bytes, expected "
                    f"{count * itemsize} for shape {shape} dtype {tag}"
                )
            f.seek(base + start)
            buf = f.read(end - start)
            if len(buf) != end - start:
                raise ValueError(f"{path}: short read for tensor {name!r} (truncated?)")
            if tag == "BF16":
                u16 = np.frombuffer(buf, dtype="<u2")
                # widen to f32 (lossless) by shifting into the high bits;
                # astype copies, so the result is writable
                arr = (u16.astype(np.uint32) << 16).view(np.float32)
            else:
                arr = np.frombuffer(
                    buf, dtype=np.dtype(_ST_DTYPES[tag]).newbyteorder("<")
                ).astype(_ST_DTYPES[tag])  # copy -> writable, native order
            out[name] = arr.reshape(shape)
    return out


def infer_config(
    tensors: Dict[str, np.ndarray],
    num_attention_heads: Optional[int] = None,
    conv_stride: Optional[tuple] = None,
) -> Wav2Vec2Config:
    """Derive the model config from tensor shapes. Conv widths/kernels, norm
    mode, conv bias, layer count, hidden/FFN widths and pos-conv geometry are
    all read off the weights; head count and strides follow the wav2vec2
    family conventions unless given."""
    n_conv = 1 + max(
        int(k.split(".")[2])
        for k in tensors
        if k.startswith("feature_extractor.conv_layers.") and k.endswith(".conv.weight")
    )
    conv_dim, conv_kernel = [], []
    for i in range(n_conv):
        w = tensors[f"feature_extractor.conv_layers.{i}.conv.weight"]  # (out, in, k)
        conv_dim.append(w.shape[0])
        conv_kernel.append(w.shape[2])
    conv_bias = "feature_extractor.conv_layers.0.conv.bias" in tensors
    feat_norm = (
        "layer"
        if "feature_extractor.conv_layers.1.layer_norm.weight" in tensors
        else "group"
    )
    hidden = tensors["feature_projection.projection.weight"].shape[0]
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in tensors if k.startswith("encoder.layers.")
    )
    ffn = tensors["encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0]
    for wv_name in (
        "encoder.pos_conv_embed.conv.weight_v",
        "encoder.pos_conv_embed.conv.parametrizations.weight.original1",
    ):
        if wv_name in tensors:
            wv = tensors[wv_name]  # (out, in/groups, k)
            break
    else:
        raise KeyError("pos_conv weight-norm params not found")
    pos_k = wv.shape[2]
    pos_groups = hidden // wv.shape[1]
    if num_attention_heads is None:
        if hidden not in _HEADS_BY_WIDTH:
            raise ValueError(
                f"cannot infer num_attention_heads for hidden_size={hidden}; "
                "pass num_attention_heads= explicitly"
            )
        num_attention_heads = _HEADS_BY_WIDTH[hidden]
    return Wav2Vec2Config(
        conv_dim=tuple(conv_dim),
        conv_stride=tuple(conv_stride) if conv_stride else _STANDARD_STRIDES[:n_conv],
        conv_kernel=tuple(conv_kernel),
        conv_bias=conv_bias,
        feat_extract_norm=feat_norm,
        hidden_size=hidden,
        num_hidden_layers=n_layers,
        num_attention_heads=num_attention_heads,
        intermediate_size=ffn,
        num_conv_pos_embeddings=pos_k,
        num_conv_pos_embedding_groups=pos_groups,
        # HF ties stable (pre-)LN to the 'layer' feat-extract mode across the
        # published family (base: group+post-LN; large/xlsr: layer+pre-LN)
        do_stable_layer_norm=(feat_norm == "layer"),
    )


def config_from_json(path_or_dict: Union[str, Dict[str, Any]]) -> Wav2Vec2Config:
    """Build the config from an HF ``config.json`` (file path or dict)."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            hc = json.load(f)
    else:
        hc = dict(path_or_dict)
    return Wav2Vec2Config(
        conv_dim=tuple(hc["conv_dim"]),
        conv_stride=tuple(hc["conv_stride"]),
        conv_kernel=tuple(hc["conv_kernel"]),
        conv_bias=hc["conv_bias"],
        feat_extract_norm=hc["feat_extract_norm"],
        hidden_size=hc["hidden_size"],
        num_hidden_layers=hc["num_hidden_layers"],
        num_attention_heads=hc["num_attention_heads"],
        intermediate_size=hc["intermediate_size"],
        num_conv_pos_embeddings=hc["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=hc["num_conv_pos_embedding_groups"],
        do_stable_layer_norm=hc["do_stable_layer_norm"],
        layer_norm_eps=hc.get("layer_norm_eps", 1e-5),
    )


def load_safetensors_params(
    path: str,
    cfg: Optional[Union[Wav2Vec2Config, str, Dict[str, Any]]] = None,
    dtype: torch.dtype = torch.float32,
) -> Wav2Vec2Model:
    """safetensors file -> the port's ``Wav2Vec2Model`` on the CPU in
    ``dtype`` (its config is ``model.cfg``). ``cfg``: a Wav2Vec2Config, a
    config.json path/dict, or None (auto: a sibling config.json if present,
    else shape inference)."""
    tensors = read_safetensors(path)
    if cfg is None:
        sibling = os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
        cfg = config_from_json(sibling) if os.path.exists(sibling) else infer_config(tensors)
    elif not isinstance(cfg, Wav2Vec2Config):
        cfg = config_from_json(cfg)
    return model_from_torch(tensors, cfg).to(dtype)
