"""The F3+F1 cross-block merge (K7) against the split pairs it replaces.

At each of the four forward block boundaries of the fused train path, K6's
F3 of block k writes ``out`` to device memory and F1 of block k + 1 reads
it back. K7 (``ops.conv_block_train.f31``) merges the two. ``out`` must
still be written, since the backward reads it as block k + 1's input, so
the merge saves one (B, T, C) read a boundary, and on the wgmma route a
launch and a wave tail. K7 has two routes, each bitwise equal to the K6
pair it merges:
  * ``f31`` in bf16 takes the wgmma route: one persistent launch walks F3's
    ``conv_wg`` tiles, then F1's, and passes ``out`` through L2. Its
    partner is the pair the train path runs, ``f3`` then ``f1``: ``out``,
    ``y0n`` and the sums bitwise.
  * ``f31_tile`` takes the tap3 route in any dtype: a block keeps a window
    of ``out`` in shared memory. Its partner is the tap3 pair ``f3_tile``
    then ``f1_tile``: ``out`` and ``y0n`` bitwise, the sums within rtol
    1e-6.
Each half of both is also held against its plain stage on the inputs it
saw: ``out`` against ``f3_plain``, ``y0n`` and the sums against
``f1_plain`` on K7's own ``out`` (activations within atol 1e-2 + rtol
1e-2 in bf16, the sums within 1e-3 of their largest entry). Chained,
``f1_plain`` on ``f3_plain``'s ``out`` would carry each flipped bf16
rounding of ``out`` into ``y0n`` through the skip, where ``y0n`` can cancel
to near zero. Then it times all four with CUDA events; the saving is
reckoned against the train path's pair.

Port of the JAX package's ``tools/bench_cross_block_merge.py``: the same
flagship shape (B, T, C = 64, 360, 320, block 1's conv0 dilation d0n = 4
by default) and the same ``np.random.default_rng(0)`` draws in the same
order, bf16 on the card. The train step runs no merge, so the extrapolation
counts the four forward boundaries of one step.

    python -m speech_decoding_tpu_torch.tools.bench_cross_block_merge              # the card
    python -m speech_decoding_tpu_torch.tools.bench_cross_block_merge --k-next 2   # block 2's conv0, d0n = 16
    python -m speech_decoding_tpu_torch.tools.bench_cross_block_merge --device cpu # plain versions, small, equivalence only
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, Optional

import numpy as np
import torch

from speech_decoding_tpu_torch.ops import conv_block_train as cbt
from speech_decoding_tpu_torch.utils.device import resolve_device

FLAGSHIP = (64, 360, 320)
SMALL = (4, 37, 16)  # the CPU run: plain versions only
K_NEXT = 1  # the first boundary: block 1's conv0, d0n = 4 (the default)
FORWARD_BOUNDARIES = 4


def make_inputs(B: int, T: int, C: int, dtype, device) -> Dict[str, torch.Tensor]:
    """y1, mi1, gb1, w2, b2, w0n, b0n from ``np.random.default_rng(0)``, drawn
    in the JAX tool's order; activations and weights in ``dtype``, the rest f32."""
    rng = np.random.default_rng(0)
    draws = {
        "y1": rng.normal(size=(B, T, C)),
        "mi1": rng.normal(size=(2, C)),
        "gb1": rng.normal(size=(2, C)),
        "w2": rng.normal(size=(3, C, 2 * C)) * 0.05,
        "b2": rng.normal(size=(1, 2 * C)).reshape(2 * C),
        "w0n": rng.normal(size=(3, C, C)) * 0.05,
        "b0n": rng.normal(size=(1, C)).reshape(C),
    }
    return {k: torch.from_numpy(v).to(device, dtype if k in ("y1", "w2", "w0n") else torch.float32)
            for k, v in draws.items()}


def best_ms(fn, warmup: int = 20, n: int = 50, rounds: int = 3) -> float:
    """CUDA-event ms per call: the best of ``rounds`` rounds of ``n`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def _close(got, want) -> float:
    """Stage tolerances against the plain version: activations atol 1e-2 +
    rtol 1e-2 in bf16; f32 results (the sums, f32 activations) 1e-3 of
    the largest entry + rtol 1e-3. Returns the largest |difference|."""
    err = 0.0
    for a, b in zip(got, want):
        atol, rtol = (1e-2, 1e-2) if a.dtype == torch.bfloat16 else (1e-3 * float(b.abs().max()), 1e-3)
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
        err = max(err, float((a.float() - b.float()).abs().max()))
    return err


def run(device: Optional[str] = None, k_next: int = K_NEXT) -> Dict:
    """Equivalence, then (on the card) both pairs and both K7 routes timed.
    Raises without a GPU unless ``device="cpu"``; raises if a merged result
    differs from its pair or from the plain version."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B, T, C = FLAGSHIP if on_card else SMALL
    dt = torch.bfloat16 if on_card else torch.float32
    x = make_inputs(B, T, C, dt, dev)
    d0n = cbt.next_conv0_dilation(k_next)
    args = (x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"], x["w0n"], x["b0n"], k_next)

    def pair(f3, f1):
        out = f3(*args[:5])
        return (out, *f1(out, x["w0n"], x["b0n"], k_next))

    def tap3_pair():  # f31_tile's bitwise partner
        return pair(cbt.f3_tile, cbt.f1_tile)

    def wgmma_pair():  # the pair the train path runs, f31's bitwise partner in bf16
        return pair(cbt.f3, cbt.f1)

    def merged():
        return cbt.f31(*args)

    def merged_tap3():
        return cbt.f31_tile(*args)

    def check_pair(merged_out, pair_out, what, sums_bitwise):
        if not (torch.equal(merged_out[0], pair_out[0]) and torch.equal(merged_out[1], pair_out[1])):
            raise AssertionError(f"{what} differs from its pair F3 + F1 in out or y0n")
        torch.testing.assert_close(merged_out[2], pair_out[2], rtol=0.0 if sums_bitwise else 1e-6, atol=0.0)
        return bool(torch.equal(merged_out[2], pair_out[2]))

    got = merged()
    route = cbt.f31.route if on_card else "plain"
    tile = merged_tap3()
    s_equal = check_pair(got, tap3_pair() if route == "tap3" else wgmma_pair(), f"f31 ({route})", route != "tap3")
    tile_s_equal = check_pair(tile, tap3_pair(), "f31_tile", False)
    out_plain = cbt.f3_plain(*args[:5])
    vs_plain = max(_close(m, (out_plain, *cbt.f1_plain(m[0], x["w0n"], x["b0n"], k_next))) for m in (got, tile))
    result = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu", "shape": [B, T, C],
              "dtype": str(dt).replace("torch.", ""), "d0n": d0n, "k_next": k_next, "route": route,
              "out_y0n_bitwise_equal": True,
              "s0n_bitwise_equal": s_equal, "tile_out_y0n_bitwise_equal": True,
              "tile_s0n_bitwise_equal": tile_s_equal, "vs_plain_max_abs_err": vs_plain}
    print(f"f31 ({route}) == its pair bitwise; f31_tile == tap3 pair (out, y0n bitwise, s0n rtol 1e-6); "
          "both ~ f31_plain", flush=True)
    if not on_card:
        print("cpu: plain versions at a small size, equivalence only", flush=True)
        return result
    ms = {name: best_ms(fn) for name, fn in (("split_ms", tap3_pair), ("pair_ms", wgmma_pair),
                                             ("merged_tap3_ms", merged_tap3), ("merged_ms", merged))}
    merged()
    saving_us = (ms["pair_ms"] - ms["merged_ms"]) * 1e3
    result.update(ms, saving_us_per_boundary=saving_us, forward_boundaries_per_step=FORWARD_BOUNDARIES,
                  saving_us_per_step=FORWARD_BOUNDARIES * saving_us, ready_waits=cbt.f31_wait_stats(),
                  timing="CUDA events; 20 warm-up calls, then the best of 3 rounds of 50; savings against the "
                         "train path's wgmma pair")
    print(f"tap3 pair F3+F1  : {ms['split_ms']:7.3f} ms", flush=True)
    print(f"wgmma pair F3+F1 : {ms['pair_ms']:7.3f} ms", flush=True)
    print(f"f31_tile (tap3)  : {ms['merged_tap3_ms']:7.3f} ms", flush=True)
    print(f"f31 ({route})    : {ms['merged_ms']:7.3f} ms  (saves {saving_us:+.1f} us a boundary)", flush=True)
    print(f"extrapolated to the {FORWARD_BOUNDARIES} forward boundaries of a step: "
          f"{FORWARD_BOUNDARIES * saving_us:+.1f} us", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--k-next", type=int, default=K_NEXT, help="the boundary's next block, 1..4 (default 1)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.k_next)), flush=True)


if __name__ == "__main__":
    main()
