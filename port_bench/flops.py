"""The yardstick: operations and bytes of the encoder's train step and the
CLIP loss, counted from shapes, and the H100's published peaks.

These are plain functions of a configuration's sizes. They do not read the
program, so a change to the program cannot move them. A multiply-add is two
operations. Elementwise work (BatchNorm, GELU, GLU, softmax, the collate) is
not counted: it is a few per cent of the operations and none of the bound.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def conv3_shapes(cfg: Dict) -> List[Tuple[int, int]]:
    """(Cin, Cout) of the fifteen k=3 convs, block by block: conv0, conv1,
    conv2 (GLU, 2·D2 outputs)."""
    D1, D2 = cfg["D1"], cfg["D2"]
    out = []
    for k in range(5):
        out += [(D1 if k == 0 else D2, D2), (D2, D2), (D2, 2 * D2)]
    return out


def encoder_forward_flops_per_row(cfg: Dict) -> float:
    """One segment through the encoder: the channel mix (X @ softmaxᵀ), the
    shared and the per-subject 1x1 convs, fifteen k=3 convs, two 1x1 heads.
    The spatial attention's logits (D1 × K² × C, once a call whatever the
    batch) are left out."""
    C, T, D1, D2, F = cfg["C"], cfg["T"], cfg["D1"], cfg["D2"], cfg["F"]
    mix = 2 * T * C * D1
    subject = 2 * (2 * T * D1 * D1)
    convs = sum(2 * 3 * T * cin * cout for cin, cout in conv3_shapes(cfg))
    heads = 2 * T * (D2 * 2 * D2 + 2 * D2 * F)
    return float(mix + subject + convs + heads)


def train_flops_per_row(cfg: Dict, batch: int) -> float:
    """One segment of a train step: the forward, the backward (the input
    and the weight gradient of every product, except the input gradient of
    the channel mix, whose input needs none) and the CLIP loss's logits
    (B × B × T·F: forward, then two products backward), per row."""
    C, T, D1, F = cfg["C"], cfg["T"], cfg["D1"], cfg["F"]
    fwd = encoder_forward_flops_per_row(cfg)
    mix = 2 * T * C * D1
    bwd = 2 * fwd - mix
    clip = 3 * 2 * batch * T * F
    return float(fwd + bwd + clip)


def k2_bound_s_per_step(cfg: Dict, batch: int) -> float:
    """K2 (the three-tap dW) over one train step's fifteen convs: for each,
    the larger of 2·3·Cin·Cout·B·T operations at the bf16 peak and its bytes
    (x and g in bf16 read once, dW in f32 written once) at the HBM peak."""
    T = cfg["T"]
    total = 0.0
    for cin, cout in conv3_shapes(cfg):
        ops = 2 * 3 * cin * cout * batch * T
        nbytes = 2 * batch * T * (cin + cout) + 4 * 3 * cin * cout
        total += max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
    return total
