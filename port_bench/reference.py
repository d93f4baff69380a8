"""The plain reference: the brain encoder of Défossez et al. 2022, its CLIP
loss and Adam, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the weights, the world and the draws it handed the
program, and it works out the rest (batch windows, dropout masks, Fourier
bases) again. It computes in float32 with TF32 off (``precision="f32"``).
The control computes the same in the nearest precision below the
configuration's: every encoder product's operands rounded to float8 e4m3
with a per-tensor scale (the configuration states bfloat16).

Layout: (B, T, C) inside; a k=3 'SAME' conv of dilation d is
y[t] = Σ_j x[t + (j−1)·d] @ W_j with zero padding, W (3, Cin, Cout).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as Fn

BN_EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# -- inputs the program and the reference share --------------------------------

def layout(name: str) -> np.ndarray:
    """(C, 2) float32 sensor positions in [0.1, 0.9]: the 208-sensor KIT helmet
    as a sunflower spiral, or the easycap-M10 montage as rings (61 less
    electrode 29), min-max normalized with a 0.1 margin."""
    if name == "kit208":
        i = np.arange(208, dtype=np.float64)
        r, theta = np.sqrt((i + 0.5) / 208), np.pi * (3 - np.sqrt(5)) * i
        loc = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1)
    elif name == "easycap_m10":
        pts = []
        counts = [1, 6, 12, 18, 24]
        for ring, count in enumerate(counts):
            rr = ring / (len(counts) - 1)
            for j in range(count):
                th = 2 * np.pi * j / count + (np.pi / count if ring % 2 else 0.0)
                pts.append((rr * np.cos(th), rr * np.sin(th)))
        loc = np.delete(np.asarray(pts, np.float64), 28, axis=0)
    else:
        raise ValueError(f"unknown layout {name!r}")
    loc = (loc - loc.min(axis=0)) / (loc.max(axis=0) - loc.min(axis=0))
    return (loc * 0.8 + 0.1).astype(np.float32)


def drop_mask(seed: int, step: int, loc: np.ndarray, d_drop: float) -> torch.Tensor:
    """The (C,) spatial-dropout mask of train step ``step`` of a run seeded
    ``seed``: one centre sensor drawn from a CPU generator seeded by
    SeedSequence([seed, 0, step]); sensors within ``d_drop`` of it are 0."""
    s = int(np.random.SeedSequence([int(seed), 0, int(step)]).generate_state(1)[0])
    center = int(torch.randint(0, len(loc), (), generator=torch.Generator().manual_seed(s)))
    pos = torch.as_tensor(np.asarray(loc, np.float32))
    dist = torch.linalg.vector_norm(pos - pos[center], dim=-1)
    return torch.where(dist < d_drop, 0.0, 1.0)


def fourier_bases(loc: np.ndarray, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K², C) cos and sin of 2π(k·x + l·y), k-major over the K×K grid."""
    loc = np.asarray(loc, np.float32)
    k = np.arange(K, dtype=np.float32).repeat(K)
    l = np.tile(np.arange(K, dtype=np.float32), K)
    phi = 2 * np.pi * (np.outer(k, loc[:, 0]) + np.outer(l, loc[:, 1]))
    return torch.from_numpy(np.cos(phi)), torch.from_numpy(np.sin(phi))


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BatchNorm statistic of the encoder, by name."""
    C, S, D1, D2, F, K = cfg["C"], cfg["S"], cfg["D1"], cfg["D2"], cfg["F"], cfg["K"]
    shapes = {
        "subject_block.spatial_attention.z_re": (D1, K * K),
        "subject_block.spatial_attention.z_im": (D1, K * K),
        "subject_block.conv.kernel": (1, D1, D1),
        "subject_block.conv.bias": (D1,),
        "subject_block.subject_kernel": (S, D1, D1),
    }
    for k in range(5):
        cin = D1 if k == 0 else D2
        for j, (ci, co) in enumerate([(cin, D2), (D2, D2), (D2, 2 * D2)]):
            shapes[f"conv{k}.conv{j}.kernel"] = (3, ci, co)
            shapes[f"conv{k}.conv{j}.bias"] = (co,)
            if j < 2:
                for leaf in ("scale", "bias", "mean", "var"):
                    shapes[f"conv{k}.batchnorm{j}.{leaf}"] = (D2,)
    shapes["conv_final1.kernel"] = (1, D2, 2 * D2)
    shapes["conv_final1.bias"] = (2 * D2,)
    shapes["conv_final2.kernel"] = (1, 2 * D2, F)
    shapes["conv_final2.bias"] = (F,)
    return shapes


def is_statistic(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


# -- precision -------------------------------------------------------------------

@contextlib.contextmanager
def exact_f32():
    """float32 products on the card: TF32 off for matmuls and cuDNN."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax → 448), with
    the identity as its gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class Prec:
    """Which rounding the encoder's product operands get."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "control"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def enc(self, x: torch.Tensor) -> torch.Tensor:
        return _round_fp8(x) if self.name == "control" else x


# -- the encoder -----------------------------------------------------------------

def _gelu(x):
    return Fn.gelu(x, approximate="none")


def _conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int, p: Prec) -> torch.Tensor:
    y = Fn.conv1d(p.enc(x).transpose(1, 2), p.enc(w).permute(2, 1, 0), padding=d, dilation=d)
    return y.transpose(1, 2) + b


def _bn(x: torch.Tensor, P: Dict, name: str, train: bool, record: Optional[Dict] = None) -> torch.Tensor:
    if train:
        mean = x.mean(dim=(0, 1))
        var = (x * x).mean(dim=(0, 1)) - mean * mean
        if record is not None:
            record[name] = (mean.detach(), var.detach(), x.shape[0] * x.shape[1])
    else:
        mean, var = P[f"{name}.mean"], P[f"{name}.var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * P[f"{name}.scale"] + P[f"{name}.bias"]


def dilations(k: int) -> Tuple[int, int]:
    return 2 ** ((2 * k) % 5), 2 ** ((2 * k + 1) % 5)


def encode(P: Dict[str, torch.Tensor], X: torch.Tensor, sidx: torch.Tensor, bases, train: bool,
           mask: Optional[torch.Tensor] = None, prec: Prec = Prec(), record: Optional[Dict] = None) -> torch.Tensor:
    """Z (B, T, F) from X (B, T, C) and subject ids (B,). In train mode
    BatchNorm takes the batch's statistics (into ``record`` by name, with
    their count, when given) and ``mask`` drops sensors."""
    cos_b, sin_b = bases
    X = X.float()
    if train and mask is not None:
        X = X * mask
    a = P["subject_block.spatial_attention.z_re"] @ cos_b + P["subject_block.spatial_attention.z_im"] @ sin_b
    X = prec.enc(X) @ prec.enc(torch.softmax(a, dim=-1)).T
    X = prec.enc(X) @ prec.enc(P["subject_block.conv.kernel"][0]) + P["subject_block.conv.bias"]
    X = torch.bmm(prec.enc(X), prec.enc(P["subject_block.subject_kernel"])[sidx])
    for k in range(5):
        d0, d1 = dilations(k)
        pre = f"conv{k}"
        Y = _conv3(X, P[f"{pre}.conv0.kernel"], P[f"{pre}.conv0.bias"], d0, prec)
        if k > 0:
            Y = Y + X
        Y = _gelu(_bn(Y, P, f"{pre}.batchnorm0", train, record))
        Y = _conv3(Y, P[f"{pre}.conv1.kernel"], P[f"{pre}.conv1.bias"], d1, prec) + Y
        Y = _gelu(_bn(Y, P, f"{pre}.batchnorm1", train, record))
        Y = _conv3(Y, P[f"{pre}.conv2.kernel"], P[f"{pre}.conv2.bias"], 2, prec)
        ga, gb = Y.chunk(2, dim=-1)
        X = ga * torch.sigmoid(gb)
    X = _gelu(prec.enc(X) @ prec.enc(P["conv_final1.kernel"][0]) + P["conv_final1.bias"])
    return _gelu(prec.enc(X) @ prec.enc(P["conv_final2.kernel"][0]) + P["conv_final2.bias"])


def clip_loss(Y: torch.Tensor, Z: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch: rows of Y (audio) and Z (brain)
    flattened and L2-normalized, logits Ŷ·Ẑᵀ·e^temp, cross-entropy against
    the diagonal both ways, mean over the batch, halved."""
    B = Y.shape[0]
    y = Y.reshape(B, -1).float()
    z = Z.reshape(B, -1).float()
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    logits = (y @ z.T) * torch.exp(temp)
    target = torch.arange(B, device=logits.device)
    return (Fn.cross_entropy(logits, target) + Fn.cross_entropy(logits.T, target)) / 2


def collate(X: torch.Tensor, stats: torch.Tensor, clamp_lim: float) -> torch.Tensor:
    """The precomputed-statistics collate of a (B, T, C) window: clip((X −
    median) / IQR, ±clamp_lim), stats (B, C, 2)."""
    return torch.clamp((X.float() - stats[:, None, :, 0]) / stats[:, None, :, 1], -clamp_lim, clamp_lim)


# -- training ----------------------------------------------------------------------

def train_steps(P0: Dict[str, torch.Tensor], temp0: float, batches: Sequence[Dict], masks: Sequence[torch.Tensor],
                bases, lr: float, prec: Prec = Prec(), device="cpu"):
    """Follow the program's first ``len(batches)`` train steps from the same
    start: each step the train forward (batch statistics, the step's
    dropout mask), the CLIP loss, its gradients and one Adam update.

    Batches hold X (B, T, C) already collated, Y (B, T, F) and subject ids.
    Returns (losses, first_grad, params_after): the gradient of the first
    update, and the trainable leaves after the last step, each a dict by
    name (the temperature as "temp")."""
    names = [n for n in P0 if not is_statistic(n)]
    P = {n: P0[n].detach().to(device, torch.float32).clone() for n in P0}
    temp = torch.tensor([float(temp0)], device=device)
    leaves = {**{n: P[n] for n in names}, "temp": temp}
    m = {n: torch.zeros_like(t) for n, t in leaves.items()}
    v = {n: torch.zeros_like(t) for n, t in leaves.items()}
    losses: List[float] = []
    first_grad = None
    with exact_f32():
        for i, (batch, mask) in enumerate(zip(batches, masks)):
            for t in leaves.values():
                t.requires_grad_(True)
            Z = encode(P, batch["X"].to(device), batch["subject_idxs"].to(device), bases, True,
                       mask.to(device), prec)
            loss = clip_loss(batch["Y"].to(device), Z, temp[0])
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = {n: torch.zeros_like(t) if g is None else g for (n, t), g in zip(leaves.items(), grads)}
                if first_grad is None:
                    first_grad = {n: g.clone() for n, g in grads.items()}
                bc1, bc2 = 1 - ADAM_B1 ** (i + 1), 1 - ADAM_B2 ** (i + 1)
                for n, t in leaves.items():
                    g = grads[n]
                    m[n].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    v[n].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    denom = (v[n].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                    t.addcdiv_(m[n], denom, value=-lr / bc1)
            for t in leaves.values():
                t.requires_grad_(False)
    after = {n: t.detach().clone() for n, t in leaves.items()}
    return losses, first_grad, after
