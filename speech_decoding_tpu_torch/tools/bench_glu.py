"""The GLU op (``ops.glu``) at the benchmark cell's shape against its bound,
the plain chain it replaces and PyTorch's own GLU.

One ConvBlock's GLU at B = 256, T = 360, D = 320 in bf16 (Y of 640
channels): forward and backward through the kernels (two launches), timed by
CUDA events over back-to-back calls and by ``torch.profiler``'s device time
(each kernel apart), beside the bound (Y read and h written forward, g and Y read
and dY written backward: 8 (B, T, D) bf16 tensors at 3.35 TB/s, 0.141 ms)
the plain chain (``a * torch.sigmoid(b)`` with autograd, what the step
ran before) and the library's call (``torch.nn.functional.glu``: ATen's
``glu`` and ``glu_backward`` kernels over the strided halves) on the same
inputs. First ``check`` holds h and dY against the f32 formulas on the same
bf16 Y and g, within one bf16 rounding, and raises past it.

    python -m speech_decoding_tpu_torch.tools.bench_glu               # the card
    python -m speech_decoding_tpu_torch.tools.bench_glu --device cpu  # plain and library, small, no times
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch
from torch.nn import functional as Fn

from speech_decoding_tpu_torch.ops import glu as gl
from speech_decoding_tpu_torch.tools.timing import HBM_BYTES_PER_S, device_ms, events_ms
from speech_decoding_tpu_torch.utils.device import resolve_device

FLAGSHIP = (256, 360, 640)  # Y: B, T, 2·D2
SMALL = (3, 17, 32)  # the CPU run: the plain version and the library's, no kernels


def make_inputs(shape, device, seed: int = 0):
    """Y bf16 (a conv's output: spread over the sigmoid's range) and a bf16
    cotangent of h, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    B, T, D2 = shape
    y = 3 * torch.randn(B, T, D2, generator=g)
    dh = torch.randn(B, T, D2 // 2, generator=g)
    return y.to(device, torch.bfloat16), dh.to(device, torch.bfloat16)


def block(fn, y, dh):
    """One block's GLU forward and backward through ``fn``; returns h and dY.
    The gradient is taken with respect to a fresh leaf on y's storage, so no
    call's autograd node outlives it (a leaf's node keeps the stream it was
    made on: one made eagerly, then met under a CUDA graph's capture, would
    make the capture wait on the default stream)."""
    y = y.detach().requires_grad_()
    h = fn(y)
    return h, torch.autograd.grad(h, y, dh)[0]


def library(y: torch.Tensor) -> torch.Tensor:
    """PyTorch's GLU over the last dim, ``torch.nn.functional.glu``: the one
    library call that computes the op, its backward ATen's ``glu_backward``."""
    return Fn.glu(y, dim=-1)


def reference(y: torch.Tensor, dh: torch.Tensor):
    """h and dY in f32 from the bf16 ``y`` and ``dh``: a·σ(b), and g·σ(b)
    and g·a·σ(b)·(1 − σ(b))."""
    a, b = y.float().chunk(2, dim=-1)
    g, s = dh.float(), torch.sigmoid(b)
    return a * s, torch.cat([g * s, g * a * s * (1 - s)], dim=-1)


def one_rounding(got: torch.Tensor, want: torch.Tensor, slack=0.0) -> float:
    """The largest share of one bf16 rounding of the f32 ``want`` that
    ``got`` is off it: |got − want| ≤ 2^-8·|want| (bf16's unit roundoff),
    with 2^-16 of it for the f32 formulas' own errors (~1e-7), plus
    ``slack``."""
    err = (got.float() - want).abs()
    return float((err / (2.0 ** -8 * (1 + 2.0 ** -8) * want.abs() + slack + 1e-30)).max())


def dy_slack(y: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
    """What two f32 ulps of σ(b) near 1 move db = g·a·σ·(1 − σ) by, where
    1 − σ cancels: 2^-23·|g·a| (0 for da)."""
    a = y.float().chunk(2, dim=-1)[0]
    ga = (dh.float() * a).abs()
    return torch.cat([torch.zeros_like(ga), 2.0 ** -23 * ga], dim=-1)


def check(shape, device, seed: int = 1) -> Dict[str, float]:
    """h and dY of the op against the f32 formulas on the same bf16 inputs,
    within one bf16 rounding (``one_rounding``; db with ``dy_slack``); the
    plain chain's errors beside them (it rounds σ(b) first, and autograd at
    every op), and the library's (``library``), with whether the op's bits
    are the library's. Raises past the op's bound; returns each output's
    largest error and share of its bound."""
    y, dh = make_inputs(shape, device, seed)
    h, dy = block(gl.glu, y, dh)
    hp, dyp = block(gl.glu_plain, y, dh)
    hl, dyl = block(library, y, dh)
    h_ref, dy_ref = reference(y, dh)
    slack = dy_slack(y, dh)
    out = {"h_max_abs_err": float((h.float() - h_ref).abs().max()), "h_over_one_rounding": one_rounding(h, h_ref),
           "dy_max_abs_err": float((dy.float() - dy_ref).abs().max()),
           "dy_over_one_rounding": one_rounding(dy, dy_ref, slack),
           "plain_h_over_one_rounding": one_rounding(hp, h_ref),
           "plain_dy_over_one_rounding": one_rounding(dyp, dy_ref, slack),
           "library_h_over_one_rounding": one_rounding(hl, h_ref),
           "library_dy_over_one_rounding": one_rounding(dyl, dy_ref, slack),
           "library_bitwise": bool(torch.equal(h, hl) and torch.equal(dy, dyl))}
    if not (out["h_over_one_rounding"] <= 1.0 and out["dy_over_one_rounding"] <= 1.0):
        raise AssertionError(f"glu off the f32 formulas by more than one bf16 rounding ({list(shape)}): {out}")
    return out


def run(device: Optional[str] = None, shape=FLAGSHIP) -> Dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        y, dh = make_inputs(SMALL, dev)
        h, dy = block(gl.glu_plain, y, dh)
        hl, dyl = block(library, y, dh)
        return {"device": "cpu", "shape": list(SMALL), "checked": "plain version and library only",
                "h_mean": float(h.detach().mean()), "dy_mean": float(dy.mean()),
                "library_h_mean": float(hl.detach().mean()), "library_dy_mean": float(dyl.mean())}
    B, T, D2 = shape
    bound_ms = 8 * B * T * (D2 // 2) * 2 / HBM_BYTES_PER_S * 1e3
    checked = check(shape, dev)
    y, dh = make_inputs(shape, dev)
    before = gl.glu.launches
    block(gl.glu, y, dh)
    launches = gl.glu.launches - before
    out = {"device": torch.cuda.get_device_name(0), "shape": [B, T, D2], "bound_ms": bound_ms, "bound_by": "bytes",
           "launches_a_block": launches, "check": checked}
    for name, fn in (("op", gl.glu), ("plain", gl.glu_plain), ("library", library)):
        ms = events_ms(lambda: block(fn, y, dh))
        dev_t = device_ms(lambda: block(fn, y, dh))
        out[name] = {"ms": ms, "pct_of_bound": 100 * bound_ms / ms,
                     "device_ms": dev_t["total"] if dev_t else "not measured",
                     "device_pct_of_bound": 100 * bound_ms / dev_t["total"] if dev_t else "not measured",
                     "kernel_records": dev_t["records"] if dev_t else "not measured",
                     "by_kernel_ms": dev_t["by_kernel"] if dev_t else "not measured"}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default where there is a card) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)


if __name__ == "__main__":
    main()
