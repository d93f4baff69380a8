"""The F3+F1 cross-block merge (K7) against the split pair it replaces.

At each of the four forward block boundaries of the fused train path, K6's
F3 of block k writes ``out`` to device memory and F1 of block k + 1 reads
it back. K7 (``ops.conv_block_train.f31``) merges the two: a block keeps its
window of ``out`` in shared memory for the next conv. ``out`` must still be
written, since the backward reads it as block k + 1's input, so the merge
saves one (B, T, C) read a boundary. K7 is built on the tap3 tile, so this
tool checks that the merged kernel equals the tap3 pair (``f3_tile`` then
``f1_tile``: ``out`` and ``y0n`` bitwise, the sums within rtol 1e-6) and
that each half agrees with the stage the train path runs on the same
inputs (in bf16 the wgmma route): ``out`` with ``f3``, ``y0n`` and the sums
with ``f1`` on K7's own ``out`` (activations within atol 1e-2 + rtol 1e-2,
the sums within 1e-3 of their largest entry). Chained, ``f1`` on ``f3``'s
``out`` would carry each flipped rounding of ``out`` into ``y0n`` through
the skip, where ``y0n`` can cancel to near zero. Then it times all three
with CUDA events; the train path's pair is the yardstick.

Port of the JAX package's ``tools/bench_cross_block_merge.py``: the same
flagship shape (B, T, C = 64, 360, 320, block 1's conv0 dilation d0n = 4)
and the same ``np.random.default_rng(0)`` draws in the same order, bf16 on
the card. The train step runs no merge, so the extrapolation counts the four
forward boundaries of one step.

    python -m speech_decoding_tpu_torch.tools.bench_cross_block_merge              # the card
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
K_NEXT = 1  # the first boundary: block 1's conv0, d0n = 4
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


def run(device: Optional[str] = None) -> Dict:
    """Equivalence, then (on the card) the split pair and the merged kernel
    timed. Raises without a GPU unless ``device="cpu"``; raises if the merged
    result differs from the split one."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B, T, C = FLAGSHIP if on_card else SMALL
    dt = torch.bfloat16 if on_card else torch.float32
    x = make_inputs(B, T, C, dt, dev)
    k_next = K_NEXT
    d0n = cbt.next_conv0_dilation(k_next)

    def pair(f3, f1):
        out = f3(x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"])
        y0n, s0n = f1(out, x["w0n"], x["b0n"], k_next)
        return out, y0n, s0n

    def split():  # the tap3 pair, K7's bitwise partner
        return pair(cbt.f3_tile, cbt.f1_tile)

    def train_pair():  # the pair the train path runs
        return pair(cbt.f3, cbt.f1)

    def merged():
        return cbt.f31(x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"], x["w0n"], x["b0n"], k_next)

    (o_a, y_a, s_a), (o_b, y_b, s_b) = split(), merged()
    if not (torch.equal(o_a, o_b) and torch.equal(y_a, y_b)):
        raise AssertionError("merged F31 differs from the tap3 pair F3 + F1 in out or y0n")
    torch.testing.assert_close(s_b, s_a, rtol=1e-6, atol=0.0)
    o_p = cbt.f3(x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"])
    y_p, s_p = cbt.f1(o_b, x["w0n"], x["b0n"], k_next)  # on K7's own out
    pair_route = cbt.conv_block_train.route if on_card else "plain"
    vs_pair = 0.0
    for a, b in ((o_b, o_p), (y_b, y_p), (s_b, s_p)):
        atol, rtol = (1e-2, 1e-2) if a.dtype == torch.bfloat16 else (1e-3 * float(b.abs().max()), 1e-3)
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
        vs_pair = max(vs_pair, float((a.float() - b.float()).abs().max()))
    result = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu", "shape": [B, T, C],
              "dtype": str(dt).replace("torch.", ""), "d0n": d0n, "k_next": k_next,
              "out_y0n_bitwise_equal": True, "s0n_bitwise_equal": bool(torch.equal(s_a, s_b)),
              "s0n_max_abs_diff": float((s_a - s_b).abs().max()), "pair_route": pair_route,
              "vs_pair_max_abs_err": vs_pair}
    print("merged == tap3 pair (out, y0n bitwise; s0n within rtol 1e-6); merged ~ the train path's stages",
          flush=True)
    if not on_card:
        print("cpu: plain versions at a small size, equivalence only", flush=True)
        return result
    t_split, t_pair, t_merged = best_ms(split), best_ms(train_pair), best_ms(merged)
    saving_us = (t_pair - t_merged) * 1e3
    result.update(split_ms=t_split, pair_ms=t_pair, merged_ms=t_merged, saving_us_per_boundary=saving_us,
                  forward_boundaries_per_step=FORWARD_BOUNDARIES,
                  saving_us_per_step=FORWARD_BOUNDARIES * saving_us,
                  timing="CUDA events; 20 warm-up calls, then the best of 3 rounds of 50; savings against the "
                         "train path's pair")
    print(f"tap3 pair F3+F1  : {t_split:7.3f} ms", flush=True)
    print(f"{pair_route} pair F3+F1 : {t_pair:7.3f} ms", flush=True)
    print(f"merged F31       : {t_merged:7.3f} ms  (saves {saving_us:+.1f} us a boundary)", flush=True)
    print(f"extrapolated to the {FORWARD_BOUNDARIES} forward boundaries of a step: "
          f"{FORWARD_BOUNDARIES * saving_us:+.1f} us", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)


if __name__ == "__main__":
    main()
