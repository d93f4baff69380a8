"""M/EEG preprocessing throughput of the port: band-pass 1-60 Hz at 1 kHz +
resample to 120 Hz, in MEG-seconds per second.

The one timing code for preprocessing, as ``bench_wav2vec`` is for the
embedder. Port of the JAX package's ``bench.py::bench_preproc`` and
``::bench_preproc_e2e``:

  * ``measure_preproc_rate``: the fused path on device-resident data — 2 x
    (208, 396,000) f32 recordings (the Gwilliams shapes
    [ref: gwilliams2022.py:249-260]) made on the device from a seeded
    ``torch.Generator``, padded by ``_pad_plan(align=25)`` (L = 409,600,
    49,152 outputs), 16 timed reps (CUDA events on a card); with
    ``route="exact"`` the exact two-stage chain (``preprocess_exact``: a
    2^19-point filter FFT, then the MNE-grid resample, whose 62,915-point
    inverse FFT has a large prime factor) on the same data;
  * ``measure_preproc_e2e``: host to host — 6 x 48 s recordings in host
    memory (numpy) through ``preprocess_batch`` (upload, fused
    filter+resample, readback to numpy) for f32, int16 and bf16 transfer,
    and ``preprocess_host`` on the host beside them. JAX's version reads a
    ``.npy`` tree from disk first; this one leaves the disk out and writes
    no file, so its numbers exclude disk reads.

The reference preprocesses 216 recordings x ~396 s in ~30 min on 20 CPU
cores [ref: README.md:26]: 47.5 MEG-s/s.

    python -m speech_decoding_tpu_torch.tools.bench_preproc [--device cuda]

It prints one JSON line per measurement and writes no file.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from speech_decoding_tpu_torch.ops.brain_preproc import (
    _pad_filter_resample, _pad_plan, preprocess_batch, preprocess_exact,
)
from speech_decoding_tpu_torch.ops.brain_preproc_host import preprocess_host, usable_cpus
from speech_decoding_tpu_torch.ops.fir import design_bandpass_fir
from speech_decoding_tpu_torch.ops.preproc_dispatch import measure_link_mbps
from speech_decoding_tpu_torch.tools import device_name, seconds_for
from speech_decoding_tpu_torch.utils.device import resolve_device

SFREQ, L_FREQ, H_FREQ, OUT_RATE = 1000.0, 1.0, 60.0, 120.0
REC_LEN = 396_000  # ~396 s at 1 kHz
REFERENCE_MEG_S_PER_S = 216 * 396.0 / 1800.0  # ≈ 47.5 (20 CPU cores)


def _best_wall(fn: Callable[[], object], reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


@torch.no_grad()
def measure_preproc_rate(
    device: Optional[Union[str, torch.device]] = None,
    reps: int = 16,
    seed: int = 0,
    channels: int = 208,
    rec_len: int = REC_LEN,
    route: str = "fused",
) -> dict:
    """Device-resident preprocessing rate (MEG-s/s) of the fused (or the
    exact) path on two recordings a call, rotating through a pool of three
    made on the device."""
    if route not in ("fused", "exact"):
        raise ValueError(f"route must be 'fused' or 'exact', got {route!r}")
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    pool = [torch.randn((channels, rec_len), generator=gen, device=dev) for _ in range(3)]
    # align=25: L = 25 * 2^k so the 1000 -> 120 Hz output length is exact
    # and FFT-smooth (preprocess_batch's plan)
    L, plans = _pad_plan([rec_len, rec_len], align=25)
    if route == "exact":
        n_out = int(round(OUT_RATE / SFREQ * rec_len))
    else:
        n_out = int(round(OUT_RATE / SFREQ * L))
    taps = torch.from_numpy(design_bandpass_fir(SFREQ, L_FREQ, H_FREQ).astype(np.float32)).to(dev)
    i = [0]

    def call():
        k = i[0]
        i[0] += 1
        x0, x1 = pool[k % 3], pool[(k + 1) % 3]
        if route == "exact":
            return preprocess_exact(torch.stack([x0, x1]), SFREQ, L_FREQ, H_FREQ, SFREQ / OUT_RATE)
        return _pad_filter_resample(taps, plans, n_out, n_out, x0, x1)

    y = call()  # warm cuFFT's plans
    if not bool(torch.isfinite(y).all()) or tuple(y.shape) != (2, channels, n_out):
        raise AssertionError(f"preprocessing output {tuple(y.shape)} is not finite or not (2, {channels}, {n_out})")
    del y
    secs = seconds_for(call, dev, reps)
    return {
        "meg_s_per_s": reps * 2 * rec_len / SFREQ / secs,
        "ms_per_call": secs / reps * 1e3,
        "route": route, "recordings_per_call": 2, "shape": [channels, rec_len],
        "padded_len": L if route == "fused" else None, "outputs": n_out,
        "reps": reps, "band_hz": [L_FREQ, H_FREQ], "sfreq": SFREQ, "out_rate": OUT_RATE,
        "clock": "CUDA events" if dev.type == "cuda" else "host",
        "device": device_name(dev), "reference_meg_s_per_s": REFERENCE_MEG_S_PER_S,
    }


def measure_preproc_e2e(
    n_rec: int = 6,
    rec_secs: float = 48.0,
    microbatch: int = 2,
    device: Optional[Union[str, torch.device]] = None,
    reps: int = 2,
    seed: int = 1,
    channels: int = 208,
) -> dict:
    """Host-to-host preprocessing rate (MEG-s/s): numpy recordings in host
    memory -> ``preprocess_batch`` -> numpy, for each transfer dtype, and
    ``preprocess_host`` on the host; best of ``reps`` after one warm-up run
    each (host clock)."""
    dev = resolve_device(device)
    rec_len = int(rec_secs * SFREQ)
    rng = np.random.default_rng(seed)
    recs = [rng.standard_normal((channels, rec_len)).astype(np.float32) for _ in range(n_rec)]
    want = (channels, int(round(rec_len * OUT_RATE / SFREQ)))
    total = n_rec * rec_secs

    def device_run(transfer_dtype):
        outs = preprocess_batch(recs, SFREQ, L_FREQ, H_FREQ, OUT_RATE, microbatch=microbatch,
                                transfer_dtype=transfer_dtype, device=dev)
        if len(outs) != n_rec or any(o.shape != want for o in outs):
            raise AssertionError(f"preprocess_batch returned {[o.shape for o in outs]}, expected {want} each")

    out = {"recordings": n_rec, "rec_secs": rec_secs, "channels": channels, "microbatch": microbatch,
           "reps": reps, "device": device_name(dev), "host_cpus": usable_cpus(),
           "source": "numpy in host memory (no disk read)", "reference_meg_s_per_s": REFERENCE_MEG_S_PER_S}
    if dev.type == "cuda":
        out["h2d_pageable_mbps"] = measure_link_mbps(dev, 32 << 20)
    for dt in ("float32", "int16", "bfloat16"):
        device_run(dt)  # warm: cuFFT plans and pinned buffers
        out[f"meg_s_per_s_{dt}"] = total / _best_wall(lambda: device_run(dt), reps)
    preprocess_host(recs, SFREQ, L_FREQ, H_FREQ, OUT_RATE)  # warm FFT plans
    out["meg_s_per_s_host"] = total / _best_wall(
        lambda: preprocess_host(recs, SFREQ, L_FREQ, H_FREQ, OUT_RATE), reps)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps({"preproc_rate": measure_preproc_rate(device=a.device)}), flush=True)
    print(json.dumps({"preproc_rate": measure_preproc_rate(device=a.device, route="exact")}), flush=True)
    print(json.dumps({"preproc_e2e": measure_preproc_e2e(device=a.device)}), flush=True)


if __name__ == "__main__":
    main()
