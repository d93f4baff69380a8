"""The train-mode ConvBlock in three fused stages a direction (K6).

Port of ``speech_decoding_tpu/ops/pallas/conv_block_train.py``. Train-mode
BatchNorm needs the batch statistics between the convs, so each block runs
as three stages per direction, one per BN sync point, with the statistics
reductions fused into the stage that produces the activation:

  forward
    F1: y0 = conv_d0(x) + b0 (+ x)                      ; Σy0, Σy0²
    F2: h0 = gelu(bn0(y0)); y1 = conv_d1(h0) + b1 + h0  ; Σy1, Σy1²
    F3: h1 = gelu(bn1(y1)); out = glu(conv_2(h1) + b2)
  backward (h0, h1 and y2 are recomputed from the saved y0, y1)
    B1: glu and conv2 backward -> du1                   ; dW2, db2, Σdu1, Σdu1·x̂1
    B2: bn1 backward, conv1 backward + skip -> du0      ; dW1, db1, Σdu0, Σdu0·x̂0
    B3: bn0 backward, conv0 backward (+ skip) -> dx     ; dW0, db0

Between the stages only O(C) math runs, as plain torch ops (means, inverse
standard deviations, the BN-backward correction terms), as the JAX package
leaves it to XLA. Numerics follow the Pallas bodies: convs accumulate in
f32; y0 and y1 are cast to the compute dtype dt before their statistics;
BatchNorm is applied in dt from f32 statistics (``_bn_apply``); GELU is
computed in f32 and cast; F2 adds its skip in f32 before its one cast; B1
and B2 take x̂ in dt, B2 and B3 recompute the x̂ of dy in f32; every dy is
cast to dt before its dW; the variance is E[y²] − mean² in f32.

K7, ``f31``, is F3 of block k merged with F1 of block k + 1 (the JAX
package's ``tools/bench_cross_block_merge.py`` experiment); ``f31_plain``
is ``f3_plain`` then ``f1_plain``. It takes the stages' route rule: on
``"wgmma"`` one persistent launch walks F3's ``conv_wg`` tiles, then F1's,
each F1 tile once the F3 tiles it reads are done, with ``out`` passed
through L2 (bitwise the wgmma pair ``f3`` then ``f1``); on ``"tap3"`` a
block keeps a window of ``out`` in shared memory for the next conv
(bitwise the tap3 pair ``f3_tile`` then ``f1_tile``). ``f31.route``
records the last launch's route; ``f31_tile`` runs the tap3 route in any
dtype. Both run in ``tools/bench_cross_block_merge.py`` of the port, never
in the train step.

Each stage function (``f1`` … ``b3``, ``f31``) launches its CUDA kernels
(``csrc/conv_block_train.cu``) for CUDA tensors and runs its plain version
(``f1_plain`` … ``b3_plain``) for CPU tensors; it never falls back on the
card. On the card a stage takes one of two routes, by ``_fast_path``:
``"wgmma"`` (bf16, C a multiple of 8, 16-byte-aligned y0/y1: K5's TMA-fed
``wgmma`` body, ``conv_wg`` of ``csrc/conv_wg.cuh`` (shared with K4), with
the stage's epilogue, its weights packed K-major here, the GLU conv's by
``conv_block.glu_pack``, and the BN·GELU of F2, F3 and B1 as a pointwise pass that
stores h0 or h1) or
``"tap3"`` (f32, and bf16 outside the rule: the conv tile of
``csrc/tap3.cuh``). ``conv_block_train.route`` records the last launch's.
``TILE`` holds every stage on the tap3 route whatever the dtype (``f3_tile``
and ``f1_tile`` are K7's bitwise partners); no training or serving path
calls them. B1, B2 and B3 take their dW from K2
(``ops.tap_conv.tap_conv_dw``) on the card (see the CUDA source for where
each stage splits). Each stage counts one launch a call.

The plain versions use ``torch.erf``; the Pallas kernels build erf from exp
(Abramowitz–Stegun 7.1.26, |err| ≤ 1.5e-7) and the CUDA kernels use
``erff``: the three differ by far less than the f32 tolerances of the tests.
"""

from __future__ import annotations

import functools
import math
import weakref
from typing import Sequence, Tuple

import torch

from speech_decoding_tpu_torch.ops import _build
from speech_decoding_tpu_torch.ops._build import INT, PTR
from speech_decoding_tpu_torch.ops.conv_block import dilations, gelu_exact_f32, glu_pack
from speech_decoding_tpu_torch.ops.tap_conv import (
    conv3, flip_taps, pack_weights, pad_channels, tap_conv_dw, tap_conv_dw_plain,
)
from speech_decoding_tpu_torch.parallel.collectives import all_reduce_

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# time rows a conv tile: csrc/conv_wg.cuh wg::TM, csrc/tap3.cuh TM (also the BN-backward pass's tile)
_TM = {"wgmma": 192, "tap3": 64}
# (pointers, ints) of each C entry before its stream; the tap3 entries come in f32 and bf16
_TAP3_ARGS = {"f1": (6, 6), "f2": (8, 4), "f3": (6, 3), "b1": (13, 3), "b2": (14, 4), "b3": (9, 6), "f31": (11, 4)}
_WG_ARGS = {"f1": (6, 7), "f2": (9, 5), "f3": (7, 4), "b1": (13, 4), "b2": (14, 5), "b3": (9, 7), "f31": (13, 5)}
LIB = _build.Library("conv_block_train", {
    **{f"cbt_{st}_{suf}": [PTR] * p + [INT] * i for st, (p, i) in _TAP3_ARGS.items() for suf in ("f32", "bf16")},
    **{f"cbt_{st}_wg": [PTR] * p + [INT] * i for st, (p, i) in _WG_ARGS.items()},
})
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _dgelu_f32(u: torch.Tensor) -> torch.Tensor:
    """d/du [u · Φ(u)] = Φ(u) + u · φ(u), exact erf form, f32."""
    uf = u.float()
    cdf = 0.5 * (1.0 + torch.erf(uf * _INV_SQRT2))
    pdf = torch.exp(-0.5 * uf * uf) * _INV_SQRT2PI
    return cdf + uf * pdf


def _bn_apply(y: torch.Tensor, mi: torch.Tensor, gb: torch.Tensor, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, x̂) in dt, one rounding per op: normalise in dt from f32 statistics.
    mi (2, C) [mean; inv], gb (2, C) [scale; bias]."""
    xhat = (y.to(dt) - mi[0].to(dt)) * mi[1].to(dt)
    return xhat * gb[0].to(dt) + gb[1].to(dt), xhat


def _stats_from_sums(s: torch.Tensor, n: int, eps: float = 1e-5):
    """(mean, biased var, inv) in f32 from the sums [Σy; Σy²]."""
    m = s[0] / n
    var = s[1] / n - m * m
    return m, var, torch.rsqrt(var + eps)


def _sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2, C) f32 [Σ a; Σ b] over batch and time."""
    return torch.stack([a.float().sum((0, 1)), b.float().sum((0, 1))])


def _h(y, mi, gb, dt):
    u, xhat = _bn_apply(y, mi, gb, dt)
    return gelu_exact_f32(u).to(dt), u, xhat


# -- plain versions: the Pallas bodies, batched over rows -------------------------------


def f1_plain(x, w0, b0, k: int):
    d0, _ = dilations(k)
    y = conv3(x, w0, d0) + b0
    if k > 0:
        y = y + x.float()
    y0 = y.to(x.dtype)
    return y0, _sums(y0, y0.float() ** 2)


def f2_plain(y0, mi0, gb0, w1, b1, k: int):
    _, d1 = dilations(k)
    h0, _, _ = _h(y0, mi0, gb0, y0.dtype)
    y1 = (conv3(h0, w1, d1) + b1 + h0.float()).to(y0.dtype)
    return y1, _sums(y1, y1.float() ** 2)


def f3_plain(y1, mi1, gb1, w2, b2):
    dt = y1.dtype
    h1, _, _ = _h(y1, mi1, gb1, dt)
    y2 = conv3(h1, w2, 2) + b2
    C = y2.shape[-1] // 2
    return y2[..., :C].to(dt) * torch.sigmoid(y2[..., C:]).to(dt)


def next_conv0_dilation(k_next: int) -> int:
    """The dilation of block k_next's conv0, the conv K7 runs after block
    k_next - 1's F3. k_next >= 1: block 0 has no block before it (and no skip
    around its conv0), so there is no boundary to merge."""
    if not 1 <= int(k_next) <= 4:
        raise ValueError(f"K7 merges F3 of block k with F1 of block k+1: k_next must be in 1..4, got {k_next}")
    return dilations(int(k_next))[0]


def f31_plain(y1, mi1, gb1, w2, b2, w0n, b0n, k_next: int):
    """K7: F3 of block k then F1 of block k_next = k + 1 (with its skip, as
    ``_f31_kernel`` of tools/bench_cross_block_merge.py computes). Returns
    (out, y0n, s0n)."""
    next_conv0_dilation(k_next)
    out = f3_plain(y1, mi1, gb1, w2, b2)
    y0n, s0n = f1_plain(out, w0n, b0n, k_next)
    return out, y0n, s0n


def b1_plain(dout, y1, mi1, gb1, w2, b2, w2t):
    dt = y1.dtype
    h1, u1, xhat1 = _h(y1, mi1, gb1, dt)
    y2 = conv3(h1, w2, 2) + b2
    C = y2.shape[-1] // 2
    a, sig = y2[..., :C], torch.sigmoid(y2[..., C:])
    df = dout.float()
    dy2 = torch.cat([df * sig, df * a * sig * (1.0 - sig)], dim=-1).to(dt)
    du1 = (conv3(dy2, w2t, 2) * _dgelu_f32(u1)).to(dt)
    return du1, _sums(du1, du1.float() * xhat1.float()), tap_conv_dw_plain(h1, dy2, 2), dy2.float().sum((0, 1))


def _bn_bwd(du, y, mi, gc, dt):
    """dy = dt(inv · (g · du − c1 − x̂ · c2)) with x̂ in f32."""
    xhat = (y.float() - mi[0]) * mi[1]
    return (mi[1] * (gc[0] * du.float() - gc[1] - xhat * gc[2])).to(dt)


def b2_plain(du1, y1, mi1, g1c, y0, mi0, gb0, w1t, k: int):
    _, d1 = dilations(k)
    dt = y1.dtype
    dy1 = _bn_bwd(du1, y1, mi1, g1c, dt)
    h0, u0, xhat0 = _h(y0, mi0, gb0, dt)
    du0 = ((conv3(dy1, w1t, d1) + dy1.float()) * _dgelu_f32(u0)).to(dt)
    return (du0, _sums(du0, du0.float() * xhat0.float()), tap_conv_dw_plain(h0, dy1, d1),
            dy1.float().sum((0, 1)))


def b3_plain(du0, y0, mi0, g0c, x, w0t, k: int):
    d0, _ = dilations(k)
    dy0 = _bn_bwd(du0, y0, mi0, g0c, y0.dtype)
    dx = conv3(dy0, w0t, d0)
    if k > 0:
        dx = dx + dy0.float()
    return dx.to(x.dtype), tap_conv_dw_plain(x, dy0, d0), dy0.float().sum((0, 1))


# -- kernel launches ---------------------------------------------------------------------


def _check(stage: str, dt, dev, expect: Sequence) -> None:
    """Every (tensor, shape, dtype) as the kernel reads it, on ``dev``."""
    if dt not in _DTYPES:
        raise TypeError(f"conv_block_train {stage} takes float32 or bfloat16 activations, got {dt}")
    for i, (t, shape, dtype) in enumerate(expect):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"conv_block_train {stage} argument {i + 1}: expected {tuple(shape)} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"conv_block_train {stage} argument {i + 1} must be contiguous on {dev}")


def _empty(dev, *shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=dev)


def _part_elems(B: int, T: int, C: int, route: str) -> int:
    """f32 scratch: two per-channel partial sums for every (recording, time
    tile) of the route's conv tile, and at least the BN-backward pass's one
    sum per (recording, 64-row tile)."""
    n = B * -(-T // _TM[route]) * 2 * C
    return max(n, B * -(-T // _TM["tap3"]) * C)


def _part(B: int, T: int, C: int, dev, route: str) -> torch.Tensor:
    return _empty(dev, _part_elems(B, T, C, route))


# K7's sync words after its partials (csrc/conv_block_train.cu f31s): a u64
# of wait cycles, the claim counter, the wait count, then one ready counter
# per (recording, time tile)
_F31_READY = 4


def _f31_scratch_elems(B: int, T: int, C: int) -> int:
    """f32 elements of K7's wgmma scratch: the wgmma route's partials, then
    its sync words (ints; the partials' count is even, so the u64 lies on
    8 bytes)."""
    return _part_elems(B, T, C, "wgmma") + _F31_READY + B * -(-T // _TM["wgmma"])


def _f31_reads(tt: int, T: int, d0n: int) -> range:
    """The time tiles of ``out`` that K7's F1 tile ``tt`` reads on the wgmma
    route (``f1_reads`` in the CUDA source): rows tt·TM − d0n ..
    (tt + 1)·TM + d0n − 1 that lie in [0, T)."""
    tm = _TM["wgmma"]
    return range(max(0, tt * tm - d0n) // tm, (min(T, (tt + 1) * tm + d0n) - 1) // tm + 1)


def _f31_order(B: int, T: int, C: int):
    """K7's tiles on the wgmma route in the order the launch claims them:
    ("F3", b, tt, column tile) for the 2C packed GLU columns, then ("F1", b,
    tt, column tile) for C; column tile fastest, then time tile."""
    tn, tt_n = 160, -(-T // _TM["wgmma"])
    return [(st, b, tt, co) for st, cols in (("F3", 2 * C), ("F1", C))
            for b in range(B) for tt in range(tt_n) for co in range(-(-cols // tn))]


def _fast_path(dt, C: int, *vec: torch.Tensor) -> bool:
    """The wgmma route's rule: bf16, C a multiple of 8 (TMA's 16-byte rows
    of h, dy and the packed weights) and at most 2048 (a pointwise pass's
    block holds a row's 8-channel groups), and 16-byte-aligned bases for the
    activations the BN·GELU and BN-backward passes read 16 bytes at a time
    (``vec``). Every other conv input is a fresh output or a copy made
    here."""
    return dt == torch.bfloat16 and C % 8 == 0 and C <= 2048 and all(t.data_ptr() % 16 == 0 for t in vec)


def _route(tile: bool, dt, C: int, *vec: torch.Tensor) -> bool:
    """True for the wgmma route; records the route of this launch."""
    fast = not tile and _fast_path(dt, C, *vec)
    conv_block_train.route = "wgmma" if fast else "tap3"
    return fast


_x_pad_last = [None]  # (weak reference to x, x's _version then, x's pad_channels copy)


def x_padded(x: torch.Tensor) -> torch.Tensor:
    """``pad_channels(x)``, as F1's conv and B3's K2 launch read x on the
    wgmma route (block 0's 270 channels become 272). The last copy is kept
    while the same tensor object has the same ``_version`` (B3 gets F1's x
    back from autograd), so a block makes the copy once; inference tensors,
    which keep no version, are copied every time."""
    if x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    inference = x.is_inference()
    last = _x_pad_last[0]
    if last is not None and not inference and last[0]() is x and last[1] == x._version:
        return last[2]
    xp = pad_channels(x)
    if not inference:
        _x_pad_last[0] = (weakref.ref(x), x._version, xp)
    return xp


def _f1_launch(x, w0, b0, k, tile=False):
    B, T, Cin = x.shape
    C, dt, dev = w0.shape[2], x.dtype, x.device
    _check("F1", dt, dev, [(x, (B, T, Cin), dt), (w0, (3, Cin, C), dt), (b0, (C,), torch.float32)])
    if k > 0 and Cin != C:
        raise ValueError(f"block k={k} has a skip around conv0, so Cin must equal C ({Cin} != {C})")
    y0, s0 = _empty(dev, B, T, C, dtype=dt), _empty(dev, 2, C)
    d0, skip = dilations(k)[0], int(k > 0)
    if _route(tile, dt, C):
        xp = x_padded(x)
        LIB("cbt_f1_wg", dev, xp, pack_weights(w0), b0, y0, _part(B, T, C, dev, "wgmma"), s0, B, T, xp.shape[2], C, d0,
            skip, _build.sms(dev))
    else:
        LIB(f"cbt_f1_{_DTYPES[dt]}", dev, x, w0, b0, y0, _part(B, T, C, dev, "tap3"), s0, B, T, Cin, C, d0, skip)
    return y0, s0


def _f2_launch(y0, mi0, gb0, w1, b1, k, tile=False):
    B, T, C = y0.shape
    dt, dev, f32 = y0.dtype, y0.device, torch.float32
    _check("F2", dt, dev, [(y0, (B, T, C), dt), (mi0, (2, C), f32), (gb0, (2, C), f32), (w1, (3, C, C), dt),
                           (b1, (C,), f32)])
    y1, s1 = _empty(dev, B, T, C, dtype=dt), _empty(dev, 2, C)
    d1 = dilations(k)[1]
    if _route(tile, dt, C, y0):
        h0 = _empty(dev, B, T, C, dtype=dt)
        LIB("cbt_f2_wg", dev, y0, mi0, gb0, pack_weights(w1), b1, h0, y1, _part(B, T, C, dev, "wgmma"), s1, B, T, C, d1,
            _build.sms(dev))
    else:
        LIB(f"cbt_f2_{_DTYPES[dt]}", dev, y0, mi0, gb0, w1, b1, y1, _part(B, T, C, dev, "tap3"), s1, B, T, C, d1)
    return y1, s1


def _f3_launch(y1, mi1, gb1, w2, b2, tile=False):
    B, T, C = y1.shape
    dt, dev, f32 = y1.dtype, y1.device, torch.float32
    _check("F3", dt, dev, [(y1, (B, T, C), dt), (mi1, (2, C), f32), (gb1, (2, C), f32), (w2, (3, C, 2 * C), dt),
                           (b2, (2 * C,), f32)])
    out = _empty(dev, B, T, C, dtype=dt)
    if _route(tile, dt, C, y1):
        h1 = _empty(dev, B, T, C, dtype=dt)
        LIB("cbt_f3_wg", dev, y1, mi1, gb1, glu_pack(w2), b2, h1, out, B, T, C, _build.sms(dev))
    else:
        LIB(f"cbt_f3_{_DTYPES[dt]}", dev, y1, mi1, gb1, w2, b2, out, B, T, C)
    return out


def _f31_route(tile: bool, dt, C: int, y1: torch.Tensor) -> str:
    """K7's route: the stages' rule (``_fast_path``; y1 is what the BN·GELU
    pass reads), tap3 whatever the dtype for ``f31_tile``."""
    return "wgmma" if not tile and _fast_path(dt, C, y1) else "tap3"


def _f31_launch(y1, mi1, gb1, w2, b2, w0n, b0n, k_next, tile=False):
    d0n = next_conv0_dilation(k_next)
    B, T, C = y1.shape
    dt, dev, f32 = y1.dtype, y1.device, torch.float32
    _check("F31", dt, dev, [(y1, (B, T, C), dt), (mi1, (2, C), f32), (gb1, (2, C), f32), (w2, (3, C, 2 * C), dt),
                            (b2, (2 * C,), f32), (w0n, (3, C, C), dt), (b0n, (C,), f32)])
    out, y0n, s0n = _empty(dev, B, T, C, dtype=dt), _empty(dev, B, T, C, dtype=dt), _empty(dev, 2, C)
    f31.route = _f31_route(tile, dt, C, y1)
    if f31.route == "wgmma":
        scratch = _empty(dev, _f31_scratch_elems(B, T, C))
        n_part = _part_elems(B, T, C, "wgmma")
        f31.sync = scratch[n_part:]
        LIB("cbt_f31_wg", dev, y1, mi1, gb1, glu_pack(w2), b2, pack_weights(w0n), b0n, _empty(dev, B, T, C, dtype=dt),
            out, y0n, scratch, f31.sync, s0n, B, T, C, d0n, _build.sms(dev))
    else:
        LIB(f"cbt_f31_{_DTYPES[dt]}", dev, y1, mi1, gb1, w2, b2, w0n, b0n, out, y0n, _part(B, T, C, dev, "tap3"), s0n,
            B, T, C, d0n)
    return out, y0n, s0n


def _b1_launch(dout, y1, mi1, gb1, w2, b2, w2t, tile=False):
    B, T, C = y1.shape
    dt, dev, f32 = y1.dtype, y1.device, torch.float32
    _check("B1", dt, dev, [(dout, (B, T, C), dt), (y1, (B, T, C), dt), (mi1, (2, C), f32), (gb1, (2, C), f32),
                           (w2, (3, C, 2 * C), dt), (b2, (2 * C,), f32), (w2t, (3, 2 * C, C), dt)])
    h1, dy2, du1 = _empty(dev, B, T, C, dtype=dt), _empty(dev, B, T, 2 * C, dtype=dt), _empty(dev, B, T, C, dtype=dt)
    db2, s = _empty(dev, 2 * C), _empty(dev, 2, C)
    if _route(tile, dt, C, y1):
        LIB("cbt_b1_wg", dev, dout, y1, mi1, gb1, glu_pack(w2), b2, pack_weights(w2t), h1, dy2, du1,
            _part(B, T, C, dev, "wgmma"), db2, s, B, T, C, _build.sms(dev))
    else:
        LIB(f"cbt_b1_{_DTYPES[dt]}", dev, dout, y1, mi1, gb1, w2, b2, w2t, h1, dy2, du1, _part(B, T, C, dev, "tap3"),
            db2, s, B, T, C)
    return du1, s, tap_conv_dw(h1, dy2, 2), db2


def _b2_launch(du1, y1, mi1, g1c, y0, mi0, gb0, w1t, k, tile=False):
    B, T, C = y1.shape
    dt, dev, f32 = y1.dtype, y1.device, torch.float32
    _check("B2", dt, dev, [(du1, (B, T, C), dt), (y1, (B, T, C), dt), (mi1, (2, C), f32), (g1c, (3, C), f32),
                           (y0, (B, T, C), dt), (mi0, (2, C), f32), (gb0, (2, C), f32), (w1t, (3, C, C), dt)])
    dy1, h0, du0 = (_empty(dev, B, T, C, dtype=dt) for _ in range(3))
    db1, s = _empty(dev, C), _empty(dev, 2, C)
    d1 = dilations(k)[1]
    if _route(tile, dt, C, du1, y1, y0):
        LIB("cbt_b2_wg", dev, du1, y1, mi1, g1c, y0, mi0, gb0, pack_weights(w1t), dy1, h0, du0,
            _part(B, T, C, dev, "wgmma"), db1, s, B, T, C, d1, _build.sms(dev))
    else:
        LIB(f"cbt_b2_{_DTYPES[dt]}", dev, du1, y1, mi1, g1c, y0, mi0, gb0, w1t, dy1, h0, du0,
            _part(B, T, C, dev, "tap3"), db1, s, B, T, C, d1)
    return du0, s, tap_conv_dw(h0, dy1, d1), db1


def _b3_launch(du0, y0, mi0, g0c, x, w0t, k, tile=False):
    B, T, C = y0.shape
    Cin, dt, dev, f32 = x.shape[2], y0.dtype, y0.device, torch.float32
    _check("B3", dt, dev, [(du0, (B, T, C), dt), (y0, (B, T, C), dt), (mi0, (2, C), f32), (g0c, (3, C), f32),
                           (x, (B, T, Cin), dt), (w0t, (3, C, Cin), dt)])
    if k > 0 and Cin != C:
        raise ValueError(f"block k={k} has a skip around conv0, so Cin must equal C ({Cin} != {C})")
    dy0, dx, db0 = _empty(dev, B, T, C, dtype=dt), _empty(dev, B, T, Cin, dtype=dt), _empty(dev, C)
    d0, skip = dilations(k)[0], int(k > 0)
    if _route(tile, dt, C, du0, y0):
        LIB("cbt_b3_wg", dev, du0, y0, mi0, g0c, pack_weights(w0t), dy0, dx, _part(B, T, C, dev, "wgmma"), db0, B, T,
            Cin, C, d0, skip, _build.sms(dev))
        return dx, tap_conv_dw(x, dy0, d0, padded=x_padded(x)), db0
    LIB(f"cbt_b3_{_DTYPES[dt]}", dev, du0, y0, mi0, g0c, w0t, dy0, dx, _part(B, T, C, dev, "tap3"), db0, B, T, Cin, C,
        d0, skip)
    return dx, tap_conv_dw(x, dy0, d0), db0


def _stage(name: str, launch, plain, kernel: str = "K6 stage"):
    """The stage wrapper: the kernels for CUDA tensors, the plain version for
    CPU tensors. Its ``launches`` counts calls that launched the kernels."""

    def stage(*args):
        if args[0].is_cuda:
            out = launch(*args)
            stage.launches += 1
            return out
        if args[0].device.type != "cpu":
            raise ValueError(f"conv_block_train {name} runs on CUDA or CPU tensors, got {args[0].device}")
        return plain(*args)

    stage.__name__ = stage.__qualname__ = name.lower()
    stage.__doc__ = f"{kernel} {name}: arguments and results as ``{plain.__name__}``."
    stage.launches = 0
    return stage


_LAUNCH = {"F1": _f1_launch, "F2": _f2_launch, "F3": _f3_launch, "B1": _b1_launch, "B2": _b2_launch,
           "B3": _b3_launch}
PLAIN = {"F1": f1_plain, "F2": f2_plain, "F3": f3_plain, "B1": b1_plain, "B2": b2_plain, "B3": b3_plain}
STAGES = {st: _stage(st, _LAUNCH[st], PLAIN[st]) for st in _LAUNCH}
f1, f2, f3, b1, b2, b3 = STAGES.values()
# every stage on the tap3 route: K7's bitwise partners and the yardstick of the wgmma route
TILE = {st: _stage(f"{st}_tile", functools.partial(_LAUNCH[st], tile=True), PLAIN[st], kernel="K6 stage on tap3")
        for st in _LAUNCH}
f3_tile, f1_tile = TILE["F3"], TILE["F1"]
f31 = _stage("F31", _f31_launch, f31_plain, kernel="K7")
f31.route = None  # the route of the last K7 launch (f31 or f31_tile): "wgmma" or "tap3"
f31.sync = None  # the last wgmma launch's sync words (f32 storage of ints; ``f31_wait_stats`` reads them)
# K7 on the tap3 route whatever the dtype: bitwise the tap3 pair f3_tile then f1_tile
f31_tile = _stage("F31_tile", functools.partial(_f31_launch, tile=True), f31_plain, kernel="K7 on tap3")


def f31_wait_stats() -> dict:
    """The last wgmma K7 launch's counters (synchronises): tiles claimed
    (every tile, plus one claim past the end by each block), F1 tiles'
    waits for F3 tiles that were not done, and the clock64 cycles those
    waits took, summed over blocks."""
    w = f31.sync
    return {"claims": int(w[2:3].view(torch.int32)), "waits": int(w[3:4].view(torch.int32)),
            "wait_cycles": int(w[0:2].view(torch.int64))}


def stage_inputs(B: int, T: int, Cin: int, C: int, k: int, dtype, device, generator: torch.Generator):
    """Random arguments of every stage of block k, as the block passes them:
    activations and weights in ``dtype``, statistics and biases in f32, with
    inverse standard deviations and BN scales in [0.5, 1.5). ``generator``
    lies on ``device``. Returns {stage name: args}."""
    def r(*shape):
        return torch.randn(*shape, device=device, generator=generator)

    def pos(n):
        return 0.5 + torch.rand(n, device=device, generator=generator)

    w0, w1, w2 = (r(3, cin, cout).div((3 * cin) ** 0.5).to(dtype) for cin, cout in ((Cin, C), (C, C), (C, 2 * C)))
    b0, b1_, b2_ = 0.1 * r(C), 0.1 * r(C), 0.1 * r(2 * C)
    x, y0, y1, dout, du1, du0 = (r(B, T, c).to(dtype) for c in (Cin, C, C, C, C, C))
    mi0, mi1 = (torch.stack([0.1 * r(C), pos(C)]) for _ in range(2))
    gb0, gb1 = (torch.stack([pos(C), 0.1 * r(C)]) for _ in range(2))
    g0c, g1c = (torch.stack([pos(C), 0.01 * r(C), 0.01 * r(C)]) for _ in range(2))
    return {
        "F1": (x, w0, b0, k), "F2": (y0, mi0, gb0, w1, b1_, k), "F3": (y1, mi1, gb1, w2, b2_),
        "B1": (dout, y1, mi1, gb1, w2, b2_, flip_taps(w2)),
        "B2": (du1, y1, mi1, g1c, y0, mi0, gb0, flip_taps(w1), k),
        "B3": (du0, y0, mi0, g0c, x, flip_taps(w0), k),
    }


# -- the differentiable block ------------------------------------------------------------


def _group_sum(s: torch.Tensor, group) -> torch.Tensor:
    """``s`` summed over the ranks of ``group`` (a new tensor; ``s`` itself
    unchanged), or ``s`` with no group."""
    return s if group is None else all_reduce_(s.clone(), group)


class _ConvBlockTrain(torch.autograd.Function):
    """JAX's ``conv_block_train`` custom VJP (``_fwd_rule``/``_bwd_rule``):
    the saved tensors are its residuals, x, y0 and y1 with the statistics;
    h0, h1 and y2 are recomputed in the backward.

    Under a data-parallel ``group`` (JAX's ``axis_name``; on a grid, its
    data axis) x is this rank's block, n = W·B·T, and the BN sums are summed over the ranks where JAX
    psums them: s0 after F1, s1 after F2, s_bn1 after B1 and s_bn0 after
    B2. The BN scale and bias gradients it returns stay this rank's partial
    sums, as JAX leaves them: the train step's gradient all-reduce sums them
    once."""

    @staticmethod
    def forward(ctx, x, w0, b0, g0, beta0, w1, b1, g1, beta1, w2, b2, k, eps, group):
        dt = x.dtype
        n = x.shape[0] * x.shape[1] * (1 if group is None else group.world)
        x = x.contiguous()
        wd = [w.to(dt).contiguous() for w in (w0, w1, w2)]
        y0, s0 = f1(x, wd[0], b0.float().contiguous(), k)
        s0 = _group_sum(s0, group)
        m0, v0, inv0 = _stats_from_sums(s0, n, eps)
        mi0, gb0 = torch.stack([m0, inv0]), torch.stack([g0, beta0]).float()
        y1, s1 = f2(y0, mi0, gb0, wd[1], b1.float().contiguous(), k)
        s1 = _group_sum(s1, group)
        m1, v1, inv1 = _stats_from_sums(s1, n, eps)
        mi1, gb1 = torch.stack([m1, inv1]), torch.stack([g1, beta1]).float()
        out = f3(y1, mi1, gb1, wd[2], b2.float().contiguous())
        ctx.save_for_backward(x, y0, y1, mi0, gb0, mi1, gb1, w0, w1, w2, b2, g0, g1)
        ctx.k, ctx.group = k, group
        ctx.mark_non_differentiable(m0, v0, m1, v1)
        return out, m0, v0, m1, v1

    @staticmethod
    def backward(ctx, dout, *_stat_grads):  # the statistics are aux outputs: no cotangent
        x, y0, y1, mi0, gb0, mi1, gb1, w0, w1, w2, bias2, g0, g1 = ctx.saved_tensors
        k, group, dt = ctx.k, ctx.group, x.dtype
        n = x.shape[0] * x.shape[1] * (1 if group is None else group.world)
        w0d, w1d, w2d = (w.to(dt) for w in (w0, w1, w2))
        du1, s_bn1, dw2, db2 = b1(dout.to(dt).contiguous(), y1, mi1, gb1, w2d.contiguous(),
                                  bias2.float().contiguous(), flip_taps(w2d))
        # (Σdu1, Σdu1·x̂1) are BN1's bias and scale gradients (this rank's
        # share); the correction terms need the global sums
        g1f, t1 = g1.float(), _group_sum(s_bn1, group)
        g1c = torch.stack([g1f, g1f * t1[0] / n, g1f * t1[1] / n])
        du0, s_bn0, dw1, db1 = b2(du1, y1, mi1, g1c, y0, mi0, gb0, flip_taps(w1d), k)
        g0f, t0 = g0.float(), _group_sum(s_bn0, group)
        g0c = torch.stack([g0f, g0f * t0[0] / n, g0f * t0[1] / n])
        dx, dw0, db0 = b3(du0, y0, mi0, g0c, x, flip_taps(w0d), k)
        return (dx, dw0.to(w0.dtype), db0, s_bn0[1], s_bn0[0], dw1.to(w1.dtype), db1, s_bn1[1], s_bn1[0],
                dw2.to(w2.dtype), db2, None, None, None)


def conv_block_train(x, w0, b0, g0, beta0, w1, b1, g1, beta1, w2, b2, k: int,
                     eps: float = 1e-5, group=None) -> Tuple[torch.Tensor, Stats]:
    """Train-mode ConvBlock k [ref: models.py:120-166], fused. x (B, T, Cin)
    in the compute dtype; w* (3, Cin/C, C/2C) conv taps (cast to x's dtype);
    b* conv biases; g*/beta* BN scale and bias (C,). Returns (out (B, T, C),
    (m0, v0, m1, v1)): the batch mean and biased variance of each BN, which
    the caller folds into the running statistics. The statistics are not
    differentiable (JAX's aux outputs). ``group`` (a ``parallel.DataGroup``):
    x is this rank's block and the statistics are the global batch's
    (synchronized BatchNorm)."""
    out, m0, v0, m1, v1 = _ConvBlockTrain.apply(x, w0, b0, g0, beta0, w1, b1, g1, beta1, w2, b2, k, eps, group)
    return out, (m0, v0, m1, v1)


conv_block_train.route = None  # the route of the last stage launched on the card: "wgmma" or "tap3"
