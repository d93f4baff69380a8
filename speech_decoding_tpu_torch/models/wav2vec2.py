"""Wav2Vec 2.0 in PyTorch — the frozen audio embedder for the CLIP target space.

Port of ``speech_decoding_tpu/models/wav2vec2.py``. The reference runs
HuggingFace's ``Wav2Vec2Model`` (facebook/wav2vec2-large-xlsr-53) to
precompute speech embeddings [ref: speech_decoding/utils/wav2vec_util.py:8-32].
Architecture (Baevski et al. 2020; the HF implementation), xlsr-53 flavour:

  * 7-layer conv feature extractor (512 ch; strides 5,2,2,2,2,2,2; kernels
    10,3,3,3,3,2,2), conv_bias=True, per-layer LayerNorm ('layer' norm mode);
  * feature projection LayerNorm(512) -> Dense(1024);
  * grouped weight-normed conv positional embedding (kernel 128, 16 groups);
  * 24 pre-LN transformer layers (d=1024, 16 heads, FFN 4096, exact GELU)
    with a final LayerNorm (do_stable_layer_norm=True);
  * the hidden-state list matches HF: the last entry is the final LayerNorm's
    output, so the reference's last-4-layer average
    [ref: wav2vec_util.py:17-20] is reproduced exactly.

The modules carry the flax names and layouts (Dense kernels (in, out), conv
kernels (k, in, out), LayerNorm ``scale``), so ``params_bridge.
load_flax_wav2vec2`` moves the JAX package's params across unchanged and
``params_from_torch`` maps a HF state_dict the way the JAX package does.
Convolutions and matmuls of an f32 model run in f32 on the card (never
TF32, ``utils.device.exact_f32``); attention is computed as the JAX module
does (scaled q, softmax, weighted v), with stock ops only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.models.params_bridge import load_flax_wav2vec2
from speech_decoding_tpu_torch.utils.device import exact_f32


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # 'layer' (large/xlsr) or 'group' (base)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "Wav2Vec2Config":
        """Small config for tests (matches an HF config with the same fields)."""
        return cls(
            conv_dim=(16, 16, 16),
            conv_stride=(5, 2, 2),
            conv_kernel=(10, 3, 3),
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=64,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4,
        )


def _param(shape, device, fill: Optional[float] = None, std: Optional[float] = None,
           generator: Optional[torch.Generator] = None) -> nn.Parameter:
    t = torch.empty(shape, device=device)
    if std is not None:
        t.normal_(0.0, std, generator=generator)
    else:
        t.fill_(fill)
    return nn.Parameter(t)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return Fn.gelu(x, approximate="none")


class Dense(nn.Module):
    """x @ kernel + bias; kernel (in, out), LeCun-normal init."""

    def __init__(self, din: int, dout: int, device=None, generator=None):
        super().__init__()
        self.kernel = _param((din, dout), device, std=din ** -0.5, generator=generator)
        self.bias = _param((dout,), device, fill=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return Fn.linear(x, self.kernel.T, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's ``scale``/``bias`` names."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device, fill=1.0)
        self.bias = _param((dim,), device, fill=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return Fn.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class Conv(nn.Module):
    """'VALID' strided conv in (B, C, T) layout; kernel (k, in, out)."""

    def __init__(self, din: int, dout: int, kernel: int, stride: int, bias: bool,
                 device=None, generator=None):
        super().__init__()
        self.stride = stride
        self.kernel = _param((kernel, din, dout), device, std=(kernel * din) ** -0.5, generator=generator)
        self.bias = _param((dout,), device, fill=0.0) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return Fn.conv1d(x, self.kernel.permute(2, 1, 0), self.bias, stride=self.stride)


class ConvFeatureExtractor(nn.Module):
    """Raw waveform (B, T) -> features (B, T', C_last). 'layer' norm mode:
    conv -> LayerNorm(channels) -> exact GELU per layer; 'group' mode:
    GroupNorm (one group per channel) on the first layer only."""

    def __init__(self, cfg: Wav2Vec2Config, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        din = 1
        for i, (dim, stride, kernel) in enumerate(zip(cfg.conv_dim, cfg.conv_stride, cfg.conv_kernel)):
            self.add_module(f"conv_{i}", Conv(din, dim, kernel, stride, cfg.conv_bias, device, generator))
            if cfg.feat_extract_norm == "layer":
                self.add_module(f"ln_{i}", LayerNorm(dim, cfg.layer_norm_eps, device))
            elif i == 0:  # GroupNorm's scale and bias, applied by Fn.group_norm below
                self.add_module("gn_0", LayerNorm(dim, cfg.layer_norm_eps, device))
            din = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :]  # (B, 1, T)
        with exact_f32():
            for i in range(len(self.cfg.conv_dim)):
                h = getattr(self, f"conv_{i}")(h)  # (B, C, T')
                if self.cfg.feat_extract_norm == "layer":
                    h = getattr(self, f"ln_{i}")(h.transpose(1, 2)).transpose(1, 2)
                elif i == 0:
                    gn = self.gn_0
                    h = Fn.group_norm(h, h.shape[1], gn.scale, gn.bias, gn.eps)
                h = _gelu(h)
        return h.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding with weight normalization: the
    direction ``weight_v`` (k, in/groups, out) is normalized over (in/groups,
    out) separately for each of the k kernel positions (HF weight_norm
    dim=2) and scaled by ``weight_g`` (k, 1, 1). An even kernel drops the
    last output frame, as HF does."""

    def __init__(self, cfg: Wav2Vec2Config, device=None, generator=None):
        super().__init__()
        k, g, d = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups, cfg.hidden_size
        self.k, self.groups = k, g
        self.weight_v = _param((k, d // g, d), device, std=0.02, generator=generator)
        self.weight_g = _param((k, 1, 1), device, fill=1.0)
        self.bias = _param((d,), device, fill=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        w = v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True)) * self.weight_g
        with exact_f32():
            y = Fn.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), self.bias,
                          padding=self.k // 2, groups=self.groups)
        if self.k % 2 == 0:
            y = y[..., :-1]
        return _gelu(y).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None, generator=None):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(d, d, device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd)

        q = self.q_proj(x) * (hd ** -0.5)
        attn = torch.einsum("bqhd,bkhd->bhqk", split(q), split(self.k_proj(x)))
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, split(self.v_proj(x)))
        return self.out_proj(out.reshape(B, T, d))


class EncoderLayer(nn.Module):
    """Pre-LN (stable-layer-norm) transformer layer; ``post_ln`` makes it the
    post-LN layer of the do_stable_layer_norm=False models (e.g. base)."""

    def __init__(self, cfg: Wav2Vec2Config, post_ln: bool = False, device=None, generator=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.post_ln = post_ln
        self.attention = SelfAttention(cfg, device, generator)
        self.ln1 = LayerNorm(cfg.hidden_size, eps, device)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, device, generator)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, device, generator)
        self.ln2 = LayerNorm(cfg.hidden_size, eps, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.post_ln:
            x = self.ln1(x + self.attention(x))
            return self.ln2(x + self.fc2(_gelu(self.fc1(x))))
        x = x + self.attention(self.ln1(x))
        return x + self.fc2(_gelu(self.fc1(self.ln2(x))))


class Wav2Vec2Model(nn.Module):
    """Full model. forward(waveform (B, T)) -> last hidden (B, T', hidden),
    or (last hidden, hidden-state list) with ``output_hidden_states``.
    Parameters are made on ``device`` from ``generator`` (random weights:
    LeCun-normal Dense and conv kernels, N(0, 0.02) positional directions,
    zero biases, unit scales)."""

    def __init__(self, cfg: Wav2Vec2Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        self.feature_extractor = ConvFeatureExtractor(cfg, device, generator)
        self.feature_projection_ln = LayerNorm(cfg.conv_dim[-1], eps, device)
        self.feature_projection = Dense(cfg.conv_dim[-1], cfg.hidden_size, device, generator)
        self.pos_conv = PositionalConvEmbedding(cfg, device, generator)
        self.encoder_ln = LayerNorm(cfg.hidden_size, eps, device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, not cfg.do_stable_layer_norm, device, generator))

    def forward(self, x: torch.Tensor, output_hidden_states: bool = False):
        cfg = self.cfg
        with exact_f32():
            h = self.feature_projection(self.feature_projection_ln(self.feature_extractor(x)))
            h = h + self.pos_conv(h)
            if not cfg.do_stable_layer_norm:
                h = self.encoder_ln(h)
            hidden_states: List[torch.Tensor] = [h]
            for i in range(cfg.num_hidden_layers):
                h = getattr(self, f"layer_{i}")(h)
                hidden_states.append(h)
            if cfg.do_stable_layer_norm:
                h = self.encoder_ln(h)
                hidden_states[-1] = h  # HF replaces the last entry with the LN'd one
        if output_hidden_states:
            return h, hidden_states
        return h


def extract_features(model: Wav2Vec2Model, x: torch.Tensor) -> torch.Tensor:
    """The conv feature-extractor path used when last4layers=False
    [ref: brennan2018.py:187-189]: (B, T) -> (B, T', 512)."""
    return model.feature_extractor(x)


# ---------------------------------------------------------------------------
# HF torch state_dict -> the flax-layout params tree (copied from the JAX
# package; numpy only). params_bridge.load_flax_wav2vec2 loads it.
# ---------------------------------------------------------------------------


def params_from_torch(state_dict: Dict[str, Any], cfg: Wav2Vec2Config) -> Dict:
    """Map a HF transformers Wav2Vec2Model state_dict into the params tree
    of this module (flax names and layouts, numpy leaves), accepting both
    weight-norm namings of the positional conv (``weight_g``/``weight_v``
    and ``parametrizations.weight.original0/1``). Accepts torch tensors or
    numpy arrays; returns ``{"params": tree}`` as the JAX package does."""

    def g(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().float().numpy() if hasattr(t, "detach") else t)

    p: Dict[str, Any] = {}

    fe: Dict[str, Any] = {}
    for i in range(len(cfg.conv_dim)):
        conv = {"kernel": g(f"feature_extractor.conv_layers.{i}.conv.weight").transpose(2, 1, 0)}
        if cfg.conv_bias:
            conv["bias"] = g(f"feature_extractor.conv_layers.{i}.conv.bias")
        fe[f"conv_{i}"] = conv
        if cfg.feat_extract_norm == "layer":
            fe[f"ln_{i}"] = {
                "scale": g(f"feature_extractor.conv_layers.{i}.layer_norm.weight"),
                "bias": g(f"feature_extractor.conv_layers.{i}.layer_norm.bias"),
            }
        elif i == 0:
            fe["gn_0"] = {
                "scale": g("feature_extractor.conv_layers.0.layer_norm.weight"),
                "bias": g("feature_extractor.conv_layers.0.layer_norm.bias"),
            }
    p["feature_extractor"] = fe

    p["feature_projection_ln"] = {
        "scale": g("feature_projection.layer_norm.weight"),
        "bias": g("feature_projection.layer_norm.bias"),
    }
    p["feature_projection"] = {
        "kernel": g("feature_projection.projection.weight").T,
        "bias": g("feature_projection.projection.bias"),
    }

    # pos conv: torch conv weight (out, in/groups, k) [weight-norm v], g (1, 1, k)
    for wg_name, wv_name in [
        ("encoder.pos_conv_embed.conv.weight_g", "encoder.pos_conv_embed.conv.weight_v"),
        (
            "encoder.pos_conv_embed.conv.parametrizations.weight.original0",
            "encoder.pos_conv_embed.conv.parametrizations.weight.original1",
        ),
    ]:
        if wg_name in state_dict:
            wv = g(wv_name)  # (out, in/groups, k)
            wg = g(wg_name)  # (1, 1, k)
            break
    else:
        raise KeyError("pos_conv weight-norm params not found in state_dict")
    p["pos_conv"] = {
        "weight_v": wv.transpose(2, 1, 0),  # -> (k, in/groups, out)
        "weight_g": wg.transpose(2, 1, 0),  # (1, 1, k) -> (k, 1, 1)
        "bias": g("encoder.pos_conv_embed.conv.bias"),
    }

    p["encoder_ln"] = {
        "scale": g("encoder.layer_norm.weight"),
        "bias": g("encoder.layer_norm.bias"),
    }

    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        p[f"layer_{i}"] = {
            "attention": {
                name: {
                    "kernel": g(f"{pre}.attention.{name}.weight").T,
                    "bias": g(f"{pre}.attention.{name}.bias"),
                }
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "ln1": {
                "scale": g(f"{pre}.layer_norm.weight"),
                "bias": g(f"{pre}.layer_norm.bias"),
            },
            "fc1": {
                "kernel": g(f"{pre}.feed_forward.intermediate_dense.weight").T,
                "bias": g(f"{pre}.feed_forward.intermediate_dense.bias"),
            },
            "fc2": {
                "kernel": g(f"{pre}.feed_forward.output_dense.weight").T,
                "bias": g(f"{pre}.feed_forward.output_dense.bias"),
            },
            "ln2": {
                "scale": g(f"{pre}.final_layer_norm.weight"),
                "bias": g(f"{pre}.final_layer_norm.bias"),
            },
        }
    return {"params": p}


def model_from_torch(state_dict: Dict[str, Any], cfg: Wav2Vec2Config) -> Wav2Vec2Model:
    """A HF state_dict as this module (f32, on the CPU)."""
    return load_flax_wav2vec2(Wav2Vec2Model(cfg, device="meta"), params_from_torch(state_dict, cfg))
