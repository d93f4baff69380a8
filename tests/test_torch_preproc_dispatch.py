"""The port's host twin and dispatcher against the JAX package's:
``ops/brain_preproc_host.py`` bit for bit (the same numpy and scipy), the
dispatcher's rules (``derive_transfer_dtype``, ``model_device_e2e``,
``plan_split``) equal, ``preprocess_auto``'s routes in order and value, and
the port's device policy: ``device="cpu"`` routes to the host, a ``cuda``
request without a card raises, and nothing falls back on its own."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from speech_decoding_tpu.ops import brain_preproc_host as jbph  # noqa: E402
from speech_decoding_tpu.ops import preproc_dispatch as jpd  # noqa: E402
from speech_decoding_tpu_torch.ops import brain_preproc as bp  # noqa: E402
from speech_decoding_tpu_torch.ops import brain_preproc_host as bph  # noqa: E402
from speech_decoding_tpu_torch.ops import preproc_dispatch as pd  # noqa: E402

torch.set_num_threads(1)

ARGS = (500.0, 1.0, 60.0, 120.0)


def _recs(seed, lengths, channels=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((channels, n)).astype(np.float32) for n in lengths]


# ---------------------------------------------------------------------------
# the host twin: the JAX package's numpy code, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pad", [0, 1, 10, 49, 80])
def test_reflect_limited_pad_np_bitwise(n_pad):
    x = _recs(0, [50])[0]
    np.testing.assert_array_equal(bph.reflect_limited_pad_np(x, n_pad), jbph.reflect_limited_pad_np(x, n_pad))


def test_fir_filter_zero_phase_np_bitwise():
    x = _recs(1, [3000], channels=4)[0]
    taps = jbph.design_bandpass_fir(500.0, 1.0, 60.0)
    np.testing.assert_array_equal(bph.fir_filter_zero_phase_np(x, taps, workers=1),
                                  jbph.fir_filter_zero_phase_np(x, taps, workers=1))


@pytest.mark.parametrize("up,down", [(1.0, 500 / 120), (2.4, 1.0), (1.0, 25 / 3), (3.0, 3.0)])
def test_fft_resample_np_bitwise(up, down):
    x = _recs(2, [3000], channels=4)[0]
    np.testing.assert_array_equal(bph.fft_resample_np(x, up, down, workers=1),
                                  jbph.fft_resample_np(x, up, down, workers=1))


@pytest.mark.parametrize("workers", [1, 3])
def test_preprocess_host_bitwise(workers):
    recs = _recs(3, [4000, 5000, 4000], channels=2)
    got = bph.preprocess_host(recs, *ARGS, workers=workers)
    want = jbph.preprocess_host(recs, *ARGS, workers=workers)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_usable_cpus_respects_affinity_and_quota(monkeypatch):
    import os

    monkeypatch.setattr(bph, "_cgroup_cpu_quota", lambda: float("inf"))
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0}, raising=False)
    assert bph.usable_cpus() == 1
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(64)), raising=False)
    monkeypatch.setattr(bph, "_cgroup_cpu_quota", lambda: 2.0)
    assert bph.usable_cpus() == 2
    assert bph._cgroup_cpu_quota() == 2.0


def test_host_twin_matches_the_exact_device_chain():
    """The host twin and the port's exact-grid chain share the MNE grids:
    they agree to f32 FFT rounding (what makes mixed routing inert)."""
    r = _recs(4, [20000], channels=4)[0]
    host = bph.preprocess_host([r], *ARGS)[0]
    dev = bp.preprocess_exact(torch.from_numpy(r), 500.0, 1.0, 60.0, down=500 / 120).numpy()
    assert host.shape == dev.shape
    assert np.abs(host - dev).max() / np.abs(dev).max() < 1e-5


# ---------------------------------------------------------------------------
# the dispatcher's rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("explicit,exact,backend", [
    (None, False, "auto"), (None, False, "host"), (None, True, "auto"), (None, False, "device"),
    ("bfloat16", True, "device"), ("int16", False, "device"),
])
def test_derive_transfer_dtype(explicit, exact, backend):
    assert pd.derive_transfer_dtype(explicit, exact, backend) == jpd.derive_transfer_dtype(explicit, exact, backend)


@pytest.mark.parametrize("rate,link,dtype", [
    (12900.0, 10_000.0, "int16"), (12900.0, 45.0, "int16"), (0.0, 45.0, "float32"),
    (5000.0, 700.0, "bfloat16"), (5000.0, 0.0, "float32"),
])
def test_model_device_e2e(rate, link, dtype):
    assert pd.model_device_e2e(rate, link, 208, 1000.0, 120.0, dtype) == \
        jpd.model_device_e2e(rate, link, 208, 1000.0, 120.0, dtype)


@pytest.mark.parametrize("host,dev", [(25.0, 75.0), (10.0, 0.0), (0.0, 10.0), (33.0, 47.0)])
def test_plan_split(host, dev):
    durs = [10.0, 3.0, 47.0, 12.5] * 5
    assert pd.plan_split(durs, host, dev) == jpd.plan_split(durs, host, dev)


@pytest.mark.parametrize("cpus", [1, 4])
@pytest.mark.parametrize("host,dev,link", [(400.0, 1000.0, 10_000.0), (500.0, 1000.0, 0.1), (50.0, 0.0, 0.0)])
def test_route_plan(monkeypatch, cpus, host, dev, link):
    """The routes preprocess_auto takes, as JAX's dispatcher decides them:
    a proportional split, or on one core the single faster route."""
    monkeypatch.setattr(pd, "usable_cpus", lambda: cpus)
    durs = [8.0, 8.4, 8.8, 9.2, 9.6, 10.0]
    rates = {"host_rate": host, "device_rate": dev, "link_mbps": link}
    routes, e2e = pd.route_plan(durs, rates, 3, 500.0, 120.0, "float32")
    assert e2e == jpd.model_device_e2e(dev, link, 3, 500.0, 120.0, "float32")
    if cpus == 1 and e2e > 0:
        assert routes == ["device" if e2e >= host else "host"] * len(durs)
    else:
        assert routes == jpd.plan_split(durs, host, e2e)


# ---------------------------------------------------------------------------
# preprocess_auto
# ---------------------------------------------------------------------------


def test_auto_mixed_split_order_and_values(monkeypatch):
    """Injected rates force a mixed split; each output sits at its input's
    index and equals JAX's dispatcher's on the same split (rtol 1e-4, atol
    1e-5; the host share bit for bit)."""
    monkeypatch.setattr(pd, "usable_cpus", lambda: 4)
    monkeypatch.setattr(jbph, "usable_cpus", lambda: 4)
    recs = _recs(5, [4000 + 200 * i for i in range(6)])
    rates = {"host_rate": 400.0, "device_rate": 1000.0, "link_mbps": 10_000.0}
    routes = pd.plan_split([r.shape[-1] / 500.0 for r in recs], 400.0,
                           pd.model_device_e2e(1000.0, 10_000.0, 3, 500.0, 120.0, "float32"))
    assert 0 < routes.count("host") < len(recs)
    got = pd.preprocess_auto(recs, *ARGS, rates=rates, verbose=False, transfer_dtype="float32", device="cpu")
    want = jpd.preprocess_auto(recs, *ARGS, rates=rates, verbose=False, transfer_dtype="float32")
    host = bph.preprocess_host(recs, *ARGS)
    for g, w, h, r, route in zip(got, want, host, recs, routes):
        assert g.shape == (3, round(r.shape[-1] * 120 / 500))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        if route == "host":
            np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("force", ["host", "device"])
def test_auto_forced_routes(force):
    recs = _recs(6, [4000, 3000])
    got = pd.preprocess_auto(recs, *ARGS, force=force, verbose=False, transfer_dtype="float32", device="cpu")
    want = jpd.preprocess_auto(recs, *ARGS, force=force, verbose=False, transfer_dtype="float32")
    if force == "host":
        ref = bph.preprocess_host(recs, *ARGS)
    else:
        ref = bp.preprocess_batch(recs, *ARGS, exact_grid=True, device="cpu")
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_auto_int16_device_route_within_quantization_bound():
    recs = _recs(7, [4000])
    d = pd.preprocess_auto(recs, *ARGS, force="device", verbose=False, device="cpu")
    ref = bph.preprocess_host(recs, *ARGS)
    assert np.abs(d[0] - ref[0]).max() / np.abs(ref[0]).max() < 5e-4


def test_auto_cpu_device_routes_to_the_host(monkeypatch):
    """``device="cpu"`` without rates or force: every recording on the host,
    no probe and no device route."""

    def _never(*a, **kw):
        raise AssertionError("no probe and no device route on device='cpu'")

    monkeypatch.setattr(pd, "preprocess_batch", _never)
    monkeypatch.setattr(pd, "probe_rates", _never)
    recs = _recs(8, [3000, 2500])
    got = pd.preprocess_auto(recs, *ARGS, verbose=False, device="cpu")
    for g, h in zip(got, bph.preprocess_host(recs, *ARGS)):
        np.testing.assert_array_equal(g, h)


def test_auto_never_mixes_routes_on_one_core(monkeypatch):
    monkeypatch.setattr(pd, "usable_cpus", lambda: 1)

    def _no_device(*a, **kw):
        raise AssertionError("device route must not run on a 1-core host pick")

    monkeypatch.setattr(pd, "preprocess_batch", _no_device)
    recs = _recs(9, [3000] * 4, channels=2)
    rates = {"host_rate": 500.0, "device_rate": 1000.0, "link_mbps": 0.1}
    got = pd.preprocess_auto(recs, *ARGS, rates=rates, verbose=False, device="cpu")
    for g, h in zip(got, bph.preprocess_host(recs, *ARGS)):
        np.testing.assert_array_equal(g, h)


def test_auto_device_error_is_raised_not_rerouted(monkeypatch):
    """A failing device route raises to the caller; the host does not take
    the work over."""

    def _broken(*a, **kw):
        raise RuntimeError("device route failed")

    monkeypatch.setattr(pd, "preprocess_batch", _broken)
    with pytest.raises(RuntimeError, match="device route failed"):
        pd.preprocess_auto(_recs(10, [3000]), *ARGS, force="device", verbose=False, device="cpu")


def test_auto_empty_and_bad_force():
    assert pd.preprocess_auto([], *ARGS, verbose=False, device="cpu") == []
    with pytest.raises(ValueError, match="force"):
        pd.preprocess_auto(_recs(11, [1000]), *ARGS, force="gpu", verbose=False, device="cpu")


def test_probe_rates_on_the_cpu_device():
    """On ``device="cpu"`` the probe measures the host only (device fields 0)
    and is cached per parameter set."""
    a = pd.probe_rates(2, 500.0, 1.0, 60.0, 120.0, probe_secs=2.0, device="cpu")
    assert a["host_rate"] > 0 and a["device_rate"] == 0.0 and a["link_mbps"] == 0.0
    assert pd.probe_rates(2, 500.0, 1.0, 60.0, 120.0, probe_secs=2.0, device="cpu") is a


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    recs = _recs(12, [1000])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.preprocess_auto(recs, *ARGS, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.preprocess_auto(recs, *ARGS, force="device", verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.probe_rates(3, *ARGS)


def test_bench_preproc_tool_runs_at_a_small_size():
    """The tool's measurements at a small size on the CPU (its numbers
    there are host timings, labelled so)."""
    from speech_decoding_tpu_torch.tools import bench_preproc

    rate = bench_preproc.measure_preproc_rate(device="cpu", reps=2, channels=2, rec_len=5000)
    assert rate["meg_s_per_s"] > 0 and rate["device"] == "cpu" and rate["clock"] == "host"
    assert rate["padded_len"] % 25 == 0 and rate["outputs"] == rate["padded_len"] * 12 // 100
    exact = bench_preproc.measure_preproc_rate(device="cpu", reps=1, channels=2, rec_len=5000, route="exact")
    assert exact["route"] == "exact" and exact["outputs"] == 600 and exact["meg_s_per_s"] > 0
    with pytest.raises(ValueError, match="route"):
        bench_preproc.measure_preproc_rate(device="cpu", route="fast")
    e2e = bench_preproc.measure_preproc_e2e(n_rec=2, rec_secs=3.0, device="cpu", reps=1, channels=2)
    for k in ("float32", "int16", "bfloat16", "host"):
        assert e2e[f"meg_s_per_s_{k}"] > 0
    assert e2e["device"] == "cpu" and "h2d_pageable_mbps" not in e2e
