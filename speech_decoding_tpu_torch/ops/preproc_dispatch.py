"""Host/device preprocessing dispatcher.

Port of ``speech_decoding_tpu/ops/preproc_dispatch.py``. The reference
preprocesses on a 20-process CPU pool (~47.5 MEG-s/s)
[ref: dataclass/gwilliams2022.py:298, README.md:26]. The device path
(``ops.brain_preproc.preprocess_batch``) must ship raw 1 kHz recordings
over the host->device link (≈0.83 MB per MEG-second as f32, ≈0.42 as
int16, plus ≈0.1 back); the host path
(``ops.brain_preproc_host.preprocess_host``) ships nothing.

``preprocess_auto`` measures three rates once per process (host->device
link MB/s, device compute MEG-s/s timed on the card, host compute
MEG-s/s), models the device's pipelined end-to-end rate as min(compute,
link/bytes), and splits the recording list between BOTH paths in
proportion to their rates, running them concurrently (the host pool in a
thread while the main thread streams the device microbatches).

Unlike the JAX dispatcher, a failed device probe or device route raises:
nothing falls back to the host on its own. The host-only route is taken when
the caller asks for it, with ``device="cpu"`` or ``force="host"``.

Numerics: the device share runs with ``exact_grid=True``, so both routes
produce the per-recording MNE grids and agree to f32 FFT rounding with
``transfer_dtype="float32"``; the default ``"int16"`` agrees to the
quantization bound.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from speech_decoding_tpu_torch.ops.brain_preproc import preprocess_batch
from speech_decoding_tpu_torch.ops.brain_preproc_host import preprocess_host, usable_cpus
from speech_decoding_tpu_torch.ops.fir import design_bandpass_fir, fir_filter_zero_phase
from speech_decoding_tpu_torch.ops.resample import fft_resample
from speech_decoding_tpu_torch.utils.device import resolve_device
from speech_decoding_tpu_torch.utils.logging import cprint

__all__ = [
    "derive_transfer_dtype",
    "measure_link_mbps",
    "probe_rates",
    "plan_split",
    "route_plan",
    "model_device_e2e",
    "preprocess_auto",
]

_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int16": 2.0}


def derive_transfer_dtype(
    explicit: Optional[str], exact_grid: bool, backend: str
) -> str:
    """The one rule for the device share's raw-upload dtype:

    * an explicit ``tpu.preproc_transfer_dtype`` always wins;
    * the pure-``device`` backend ships float32 (parity-first default);
    * the ``auto``/``host`` routes ship int16 (the link-bound default)
      — unless ``preprocs.exact_mne_grid`` is set, whose byte-stable caches
      int16 quantization would break, so float32.
    """
    if explicit:
        return str(explicit)
    if backend == "device" or exact_grid:
        return "float32"
    return "int16"


# probe results are stable within a process; cached per (device, sfreq, band, rate)
_probe_cache: Dict[tuple, dict] = {}
_probe_lock = threading.Lock()


def model_device_e2e(
    device_rate: float,
    link_mbps: float,
    channels: int,
    sfreq: float,
    out_rate: float,
    transfer_dtype: str = "int16",
) -> float:
    """Pipelined device e2e rate (MEG-s/s): transfers overlap compute
    (``preprocess_batch`` double-buffers), so the stream runs at the slower
    of the two. Link bytes per MEG-second = raw upload + f32 readback."""
    up = channels * sfreq * _BYTES[transfer_dtype] / 1e6
    down = channels * out_rate * 4.0 / 1e6
    link_rate = link_mbps / (up + down) if link_mbps > 0 else 0.0
    return min(float(device_rate), link_rate)


def _host_rate(rec: np.ndarray, secs: float, sfreq, l_freq, h_freq, out_rate) -> float:
    """Host MEG-s/s on one probe recording, the second rep timed (the first
    warms caches)."""
    preprocess_host([rec], sfreq, l_freq, h_freq, out_rate)
    t0 = time.perf_counter()
    preprocess_host([rec], sfreq, l_freq, h_freq, out_rate)
    return secs / (time.perf_counter() - t0)


def measure_link_mbps(dev: torch.device, nbytes: int = 8 << 20) -> float:
    """Host->device MB/s of a pageable numpy buffer on a card: the second of
    two uploads, timed on the host clock up to a synchronize."""
    buf = np.random.default_rng(1).standard_normal(nbytes // 4).astype(np.float32)
    torch.from_numpy(buf).to(dev)  # warm lazy init
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    torch.from_numpy(buf).to(dev)
    torch.cuda.synchronize(dev)
    return buf.nbytes / 1e6 / (time.perf_counter() - t0)


def _device_rate(rec: np.ndarray, secs: float, sfreq, l_freq, h_freq, out_rate,
                 dev: torch.device) -> float:
    """Device MEG-s/s of the exact-grid chain (filter FFT + MNE-grid
    resample FFT: what the dispatcher's device share runs) on
    device-resident data, timed by CUDA events."""
    taps = torch.from_numpy(design_bandpass_fir(sfreq, l_freq, h_freq).astype(np.float32)).to(dev)
    x = torch.from_numpy(rec).to(dev)
    down = float(sfreq) / float(out_rate)

    def chain():
        return fft_resample(fir_filter_zero_phase(x, taps), 1.0, down)

    chain()  # warm cuFFT's plans
    reps = 4
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        chain()
    end.record()
    end.synchronize()
    return reps * secs / (start.elapsed_time(end) / 1e3)


@torch.no_grad()
def probe_rates(
    channels: int,
    sfreq: float,
    l_freq: float,
    h_freq: float,
    out_rate: float,
    probe_secs: float = 16.0,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Measure link MB/s, device compute MEG-s/s and host compute MEG-s/s.
    On ``device="cpu"`` the device fields are 0 (host-only routing, as the
    caller asked); on a card any failure raises. Cached per process +
    device + parameter set."""
    dev = resolve_device(device)
    key = (str(dev), channels, float(sfreq), float(l_freq), float(h_freq), float(out_rate))
    with _probe_lock:
        if key in _probe_cache:
            return _probe_cache[key]

    T = int(probe_secs * sfreq)
    rec = np.random.default_rng(0).standard_normal((channels, T)).astype(np.float32)
    host_rate = _host_rate(rec, probe_secs, sfreq, l_freq, h_freq, out_rate)
    link_mbps = device_rate = 0.0
    if dev.type != "cpu":
        link_mbps = measure_link_mbps(dev)
        device_rate = _device_rate(rec, probe_secs, sfreq, l_freq, h_freq, out_rate, dev)

    out = {
        "host_rate": round(host_rate, 2),
        "device_rate": round(device_rate, 2),
        "link_mbps": round(link_mbps, 2),
    }
    with _probe_lock:
        _probe_cache[key] = out
    return out


def plan_split(
    durations: Sequence[float],
    host_rate: float,
    device_e2e: float,
) -> List[str]:
    """Assign each recording to 'host' or 'device' so assigned duration is
    proportional to the measured rates (both routes run concurrently, so the
    wall time is ~total/(host_rate + device_e2e)). Greedy: each recording
    goes to the route furthest behind its target share."""
    total = host_rate + device_e2e
    if device_e2e <= 0 or total <= 0:
        return ["host"] * len(durations)
    if host_rate <= 0:
        return ["device"] * len(durations)
    routes, dev_t, host_t = [], 0.0, 0.0
    for d in durations:
        # pick the route whose projected finish time is earlier
        if (dev_t + d) / device_e2e <= (host_t + d) / host_rate:
            routes.append("device")
            dev_t += d
        else:
            routes.append("host")
            host_t += d
    return routes


def route_plan(
    durations: Sequence[float],
    rates: dict,
    channels: int,
    sfreq: float,
    out_rate: float,
    transfer_dtype: str = "int16",
) -> Tuple[List[str], float]:
    """The routes ``preprocess_auto`` takes for recordings of these durations
    under these probe ``rates``, and the modelled device e2e rate.

    The device stream needs a host core for its own pump (quantize, copies,
    readback); on a single-core host a concurrent FFT thread starves it, so
    routes are never MIXED there — the single faster route takes all.
    ``usable_cpus``: the affinity/cgroup grant."""
    dev_e2e = model_device_e2e(
        rates["device_rate"], rates["link_mbps"], channels, sfreq, out_rate, transfer_dtype
    )
    if dev_e2e > 0 and usable_cpus() <= 1:
        best = "device" if dev_e2e >= rates["host_rate"] else "host"
        return [best] * len(durations), dev_e2e
    return plan_split(durations, rates["host_rate"], dev_e2e), dev_e2e


def preprocess_auto(
    recordings: Sequence[np.ndarray],
    sfreq: float,
    l_freq: float,
    h_freq: float,
    out_rate: float,
    microbatch: int = 4,
    transfer_dtype: str = "int16",
    workers: Optional[int] = None,
    force: Optional[str] = None,
    rates: Optional[dict] = None,
    verbose: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> List[np.ndarray]:
    """Band-pass + resample with host/device routing (module docstring).
    Same contract as ``preprocess_batch(to_host=True)``; output order
    matches the input order whatever the split.

    ``force``: "host" / "device" bypasses the probe. ``rates``: inject probe
    results (tests; repeated builds). ``device``: where the device share
    runs (default ``cuda``; raises without a GPU). With ``device="cpu"`` and
    no ``rates`` or ``force`` every recording goes to the host."""
    recordings = list(recordings)
    dev = resolve_device(device)
    if not recordings:
        return []
    channels = recordings[0].shape[0]
    if force in ("host", "device"):
        routes = [force] * len(recordings)
    elif force is not None:
        raise ValueError(f"force must be 'host', 'device' or None, got {force!r}")
    elif rates is None and dev.type == "cpu":
        routes = ["host"] * len(recordings)
    else:
        rates = rates or probe_rates(channels, sfreq, l_freq, h_freq, out_rate, device=dev)
        routes, dev_e2e = route_plan([r.shape[-1] / sfreq for r in recordings], rates, channels, sfreq,
                                     out_rate, transfer_dtype)
        if verbose:
            cprint(
                f"[preproc_dispatch] host {rates['host_rate']:.0f} MEG-s/s, "
                f"device e2e {dev_e2e:.0f} (compute {rates['device_rate']:.0f},"
                f" link {rates['link_mbps']:.0f} MB/s) -> "
                f"{routes.count('device')}/{len(routes)} recordings to {dev}",
                "cyan",
            )

    host_idx = [i for i, r in enumerate(routes) if r == "host"]
    dev_idx = [i for i, r in enumerate(routes) if r == "device"]
    outs: List[Optional[np.ndarray]] = [None] * len(recordings)
    host_err: List[BaseException] = []

    def _host_work():
        try:
            res = preprocess_host(
                [recordings[i] for i in host_idx], sfreq, l_freq, h_freq,
                out_rate, workers=workers,
            )
            for i, y in zip(host_idx, res):
                outs[i] = y
        except BaseException as e:  # re-raised on the caller thread below
            host_err.append(e)

    th = None
    if host_idx:
        th = threading.Thread(target=_host_work, daemon=True)
        th.start()
    try:
        if dev_idx:
            res = preprocess_batch(
                [recordings[i] for i in dev_idx], sfreq, l_freq, h_freq, out_rate,
                microbatch=microbatch, to_host=True, transfer_dtype=transfer_dtype,
                exact_grid=True, device=dev,
            )
            for i, y in zip(dev_idx, res):
                outs[i] = y
    finally:
        if th is not None:
            th.join()
    if host_err:
        raise host_err[0]
    return outs  # type: ignore[return-value]
