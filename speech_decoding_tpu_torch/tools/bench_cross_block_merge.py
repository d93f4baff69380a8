"""The F3+F1 cross-block merge (K7) against the split pair it replaces.

At each of the four forward block boundaries of the fused train path, K6's
F3 of block k writes ``out`` to device memory and F1 of block k + 1 reads
it back. K7 (``ops.conv_block_train.f31``) merges the two: a block keeps its
window of ``out`` in shared memory for the next conv. ``out`` must still be
written, since the backward reads it as block k + 1's input, so the merge
saves one (B, T, C) read a boundary. This tool checks that the merged kernel
equals the split pair (``out`` and ``y0n`` bitwise, the sums within rtol
1e-6), then times both with CUDA events.

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

    def split():
        out = cbt.f3(x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"])
        y0n, s0n = cbt.f1(out, x["w0n"], x["b0n"], k_next)
        return out, y0n, s0n

    def merged():
        return cbt.f31(x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"], x["w0n"], x["b0n"], k_next)

    (o_a, y_a, s_a), (o_b, y_b, s_b) = split(), merged()
    if not (torch.equal(o_a, o_b) and torch.equal(y_a, y_b)):
        raise AssertionError("merged F31 differs from the split F3 + F1 in out or y0n")
    torch.testing.assert_close(s_b, s_a, rtol=1e-6, atol=0.0)
    result = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu", "shape": [B, T, C],
              "dtype": str(dt).replace("torch.", ""), "d0n": d0n, "k_next": k_next,
              "out_y0n_bitwise_equal": True, "s0n_bitwise_equal": bool(torch.equal(s_a, s_b)),
              "s0n_max_abs_diff": float((s_a - s_b).abs().max())}
    print("merged == split (out, y0n bitwise; s0n within rtol 1e-6)", flush=True)
    if not on_card:
        print("cpu: plain versions at a small size, equivalence only", flush=True)
        return result
    t_split, t_merged = best_ms(split), best_ms(merged)
    saving_us = (t_split - t_merged) * 1e3
    result.update(split_ms=t_split, merged_ms=t_merged, saving_us_per_boundary=saving_us,
                  forward_boundaries_per_step=FORWARD_BOUNDARIES,
                  saving_us_per_step=FORWARD_BOUNDARIES * saving_us,
                  timing="CUDA events; 20 warm-up calls, then the best of 3 rounds of 50")
    print(f"split F3+F1 : {t_split:7.3f} ms", flush=True)
    print(f"merged F31  : {t_merged:7.3f} ms  (saves {saving_us:+.1f} us a boundary)", flush=True)
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
