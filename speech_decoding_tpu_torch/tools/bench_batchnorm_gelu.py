"""The train-mode BatchNorm + GELU op (``ops.batchnorm_gelu``) at the
benchmark cell's shape against its bound and its plain version.

One layer of the module path's ConvBlock at B = 256, T = 360, C = 320 in
bf16: forward and backward through the kernels (six launches), with the
residual input (nine of the step's ten layers) and without, each timed by
CUDA events over back-to-back calls and by ``torch.profiler``'s device time
(each kernel apart), beside the bound (y and h forward, dh, y and dy
backward: five (B, T, C) bf16 tensors at 3.35 TB/s, 0.088 ms) and the
plain version's eager chain (``TorchBatchNorm``'s train formulas, GELU and
autograd, what the step ran before) on the same inputs. First ``check``
holds h, the moved running statistics, dy, the skip's gradient, dscale
and dbias against the plain version at the card tests' tolerances, and
raises past one.

    python -m speech_decoding_tpu_torch.tools.bench_batchnorm_gelu               # the card
    python -m speech_decoding_tpu_torch.tools.bench_batchnorm_gelu --device cpu  # plain version, small, no times
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from speech_decoding_tpu_torch.ops import batchnorm_gelu as bg
from speech_decoding_tpu_torch.tools.timing import HBM_BYTES_PER_S, device_ms, events_ms
from speech_decoding_tpu_torch.utils.device import resolve_device

FLAGSHIP = (256, 360, 320)
SMALL = (3, 17, 16)  # the CPU run: the plain version only


def make_inputs(shape, skip: bool, device, seed: int = 0):
    """a (and the skip) bf16 with a non-zero mean, f32 scale, bias and
    running statistics, a bf16 cotangent, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    C = shape[-1]
    a = 2 * torch.randn(*shape, generator=g) + 0.5
    s = torch.randn(*shape, generator=g) if skip else None
    scale, bias = 0.5 + torch.rand(C, generator=g), 0.1 * torch.randn(C, generator=g)
    mean, var = 0.1 * torch.randn(C, generator=g), 0.5 + torch.rand(C, generator=g)
    dh = torch.randn(*shape, generator=g)
    to = dict(device=device, dtype=torch.bfloat16)
    return (a.to(**to).requires_grad_(), None if s is None else s.to(**to).requires_grad_(),
            scale.to(device).requires_grad_(), bias.to(device).requires_grad_(), mean.to(device), var.to(device),
            dh.to(**to))


def layer(fn, a, s, scale, bias, mean, var, dh):
    """One layer's forward and backward through ``fn``; returns h."""
    h = fn(a, s, scale, bias, mean, var)
    torch.autograd.grad(h, [t for t in (a, s, scale, bias) if t is not None], dh)
    return h


def _over(err: torch.Tensor, tol: torch.Tensor) -> float:
    """The largest share of its tolerance that an error takes."""
    return float((err / tol).max())


def check(shape, skip: bool, device, seed: int = 1) -> Dict[str, float]:
    """One layer through the kernels against the plain version on the same
    inputs, at the card tests' tolerances (``tests/
    test_torch_batchnorm_gelu_cuda.py`` gives their reasons): h against the
    bf16 plain version, |Δh| ≤ 2^-6·|h| + 2^-8; the moved running
    statistics, |Δ| ≤ 1e-5·|s| + 1e-7; dy against the f32 plain version on
    y = bf16(a + skip), |Δdy| ≤ 2^-8·|dy| + 2^-14·inv0·scale·(|dh| + 1 +
    |x̂|), the skip's gradient the same tensor; dscale and dbias within
    2^-16 of Σ|dh|·(1 + |x̂|). Raises past a tolerance; returns each
    output's largest error and its largest share of its tolerance (dy's
    near 1 where its one rounding nearly reaches bf16's unit roundoff,
    2^-8: the f32 term holds the room)."""
    a, s, scale, bias, mean, var, dh = make_inputs(shape, skip, device, seed)
    leaves = [t for t in (a, s, scale, bias) if t is not None]
    mk, vk = mean.clone(), var.clone()
    h = bg.bn_gelu_train(a, s, scale, bias, mk, vk)
    grads = torch.autograd.grad(h, leaves, dh)
    dy, dscale, dbias = grads[0], grads[-2], grads[-1]
    if skip and not torch.equal(grads[1], dy):
        raise AssertionError("bn_gelu_train: the skip's gradient is not dy")
    mp, vp = mean.clone(), var.clone()
    with torch.no_grad():
        hp = bg.bn_gelu_train_plain(a, s, scale, bias, mp, vp).float()

    y = (a if s is None else a + s).detach().float().requires_grad_()
    sc, bi = scale.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()
    hr = bg.bn_gelu_train_plain(y, None, sc, bi, mean.clone(), var.clone())
    dy_ref, dscale_ref, dbias_ref = torch.autograd.grad(hr, [y, sc, bi], dh.float())
    with torch.no_grad():
        m, v = bg.batch_moments(y)
        inv0 = torch.rsqrt(v + 1e-5)
        xhat = (y - m) * inv0
        dhf = dh.float().abs()
        sums = (dhf * (1 + xhat.abs())).sum(dim=(0, 1))
        errs = {"h": ((h.float() - hp).abs(), 2.0 ** -6 * hp.abs() + 2.0 ** -8),
                "running_mean": ((mk - mp).abs(), 1e-5 * mp.abs() + 1e-7),
                "running_var": ((vk - vp).abs(), 1e-5 * vp.abs() + 1e-7),
                "dy": ((dy.float() - dy_ref).abs(),
                       2.0 ** -8 * dy_ref.abs() + 2.0 ** -14 * inv0 * scale * (dhf + 1 + xhat.abs())),
                "dscale": ((dscale - dscale_ref).abs(), 2.0 ** -16 * sums),
                "dbias": ((dbias - dbias_ref).abs(), 2.0 ** -16 * sums)}
    out = {}
    for name, (err, tol) in errs.items():
        out[f"{name}_max_abs_err"], out[f"{name}_over_tol"] = float(err.max()), _over(err, tol)
    bad = {k: v for k, v in out.items() if k.endswith("_over_tol") and not v <= 1.0}
    if bad:
        raise AssertionError(f"bn_gelu_train off its plain version ({'with' if skip else 'without'} the skip, "
                             f"{list(shape)}): {bad}")
    return out


def run(device: Optional[str] = None, shape=FLAGSHIP) -> Dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        a, s, scale, bias, mean, var, dh = make_inputs(SMALL, True, dev)
        h = layer(bg.bn_gelu_train, a, s, scale, bias, mean, var, dh)
        return {"device": "cpu", "shape": list(SMALL), "checked": "plain version only",
                "h_mean": float(h.detach().mean())}
    B, T, C = shape
    bound_ms = 5 * B * T * C * 2 / HBM_BYTES_PER_S * 1e3
    out = {"device": torch.cuda.get_device_name(0), "shape": [B, T, C], "bound_ms": bound_ms, "bound_by": "bytes"}
    for skip in (True, False):
        checked = check(shape, skip, dev)
        args = make_inputs(shape, skip, dev)
        before = bg.bn_gelu_train.launches
        layer(bg.bn_gelu_train, *args)
        launches = bg.bn_gelu_train.launches - before
        ms = events_ms(lambda: layer(bg.bn_gelu_train, *args))
        plain_ms = events_ms(lambda: layer(bg.bn_gelu_train_plain, *args))
        dev_k = device_ms(lambda: layer(bg.bn_gelu_train, *args))
        dev_p = device_ms(lambda: layer(bg.bn_gelu_train_plain, *args))
        out["with_skip" if skip else "without_skip"] = {
            "ms": ms, "plain_ms": plain_ms, "pct_of_bound": 100 * bound_ms / ms,
            "device_ms": dev_k["total"] if dev_k else "not measured",
            "device_pct_of_bound": 100 * bound_ms / dev_k["total"] if dev_k else "not measured",
            "kernel_records": dev_k["records"] if dev_k else "not measured",
            "by_kernel_ms": dev_k["by_kernel"] if dev_k else "not measured",
            "plain_device_ms": dev_p["total"] if dev_p else "not measured",
            "plain_kernel_records": dev_p["records"] if dev_p else "not measured",
            "launches_a_layer": launches, "check": checked}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default where there is a card) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)


if __name__ == "__main__":
    main()
