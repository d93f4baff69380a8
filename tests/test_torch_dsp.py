"""The port's brain DSP against the JAX package's on the same inputs:
``ops/fir.py`` (tap design bitwise, reflect-limited padding, zero-phase
filtering), ``ops/resample.py`` (FFT resample, windowed-sinc resample),
``ops/brain_preproc.py`` (``preprocess_exact``, ``preprocess_batch`` on
every route, the quantized transfers) and the frozen MNE-grid goldens.

Tolerances: f32 DSP rtol 1e-4, atol 1e-5 on unit-variance inputs (both
sides run f32 FFTs, in other libraries); numpy copies and the quantized
transfer payloads bitwise; the goldens at the JAX test's 2e-4."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.ops import brain_preproc as jbp  # noqa: E402
from speech_decoding_tpu.ops import fir as jfir  # noqa: E402
from speech_decoding_tpu.ops import resample as jres  # noqa: E402
from speech_decoding_tpu_torch.ops import brain_preproc as bp  # noqa: E402
from speech_decoding_tpu_torch.ops import fir  # noqa: E402
from speech_decoding_tpu_torch.ops import resample as res  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/fir.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sfreq,l_freq,h_freq", [
    (1000.0, 1.0, 60.0), (500.0, 1.0, 60.0), (120.0, 0.5, 40.0),
    (1000.0, None, 60.0), (1000.0, 1.0, None), (200.0, 0.1, 50.0),
])
def test_design_bandpass_fir_bitwise(sfreq, l_freq, h_freq):
    got = fir.design_bandpass_fir(sfreq, l_freq, h_freq)
    want = jfir.design_bandpass_fir(sfreq, l_freq, h_freq)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_design_bandpass_fir_needs_an_edge():
    with pytest.raises(ValueError, match="at least one"):
        fir.design_bandpass_fir(1000.0, None, None)


@pytest.mark.parametrize("n_pad", [1, 5, 9, 20])
def test_reflect_limited_pad(n_pad):
    """Within one reflection and beyond it (n_pad > T-1: zero-extended)."""
    x = _normal(1, (2, 3, 10))
    got = fir.reflect_limited_pad(torch.from_numpy(x), n_pad)
    assert got.shape[-1] == 10 + 2 * n_pad
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfir.reflect_limited_pad(jnp.asarray(x), n_pad)))


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("T", [2000, 600])
def test_fir_filter_zero_phase(pad, T):
    """T=600 is shorter than the 1651 taps: the pad zero-extends."""
    x = _normal(2, (3, T))
    taps = jfir.design_bandpass_fir(500.0, 1.0, 60.0)
    got = fir.fir_filter_zero_phase(torch.from_numpy(x), taps, pad=pad)
    _close(got, jfir.fir_filter_zero_phase(jnp.asarray(x), jnp.asarray(taps), pad=pad))


def test_bandpass_filter():
    x = _normal(3, (2, 3000))
    _close(fir.bandpass_filter(torch.from_numpy(x), 250.0, 1.0, 40.0),
           jfir.bandpass_filter(jnp.asarray(x), 250.0, 1.0, 40.0))


# ---------------------------------------------------------------------------
# ops/resample.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,up,down", [
    ((3, 1000), 1.0, 4.0),     # down, even Nyquist bin: folded
    ((3, 999), 1.0, 3.0),      # down, odd output length
    ((2, 300), 3.0, 1.0),      # up, even Nyquist bin: split
    ((2, 301), 2.5, 1.0),      # up, odd input
    ((2, 3, 149), 120.0 / 49.666, 1.0),  # a non-rational ratio, batched leading axes
    ((4, 500), 1.0, 1.0),      # up == down: returned at once
    ((1, 6000), 120.0, 500.0),
])
def test_fft_resample(shape, up, down):
    x = _normal(4, shape)
    got = res.fft_resample(torch.from_numpy(x), up=up, down=down)
    _close(got, jres.fft_resample(jnp.asarray(x), up=up, down=down))


@pytest.mark.parametrize("n_in,n_out", [(16, 8), (16, 9), (16, 24), (15, 30), (16, 16)])
def test_spectral_resize(n_in, n_out):
    """Both Nyquist cases of scipy's resize: folded when downsampling,
    split when upsampling (exact copies and products)."""
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((2, n_in)) + 1j * rng.standard_normal((2, n_in))).astype(np.complex64)
    got = res._spectral_resize(torch.from_numpy(X), n_in, n_out).numpy()
    np.testing.assert_array_equal(got, np.asarray(jres._spectral_resize(jnp.asarray(X), n_in, n_out)))


@pytest.mark.parametrize("orig,new,width,shape", [
    (44100, 16000, 6, (2, 4410)),
    (44100, 16000, 128, (1, 4410)),
    (8000, 16000, 6, (2, 3, 800)),
    (16000, 16000, 6, (2, 800)),
])
def test_sinc_resample(orig, new, width, shape):
    x = _normal(6, shape)
    got = res.sinc_resample(torch.from_numpy(x), orig, new, lowpass_filter_width=width)
    _close(got, jres.sinc_resample(jnp.asarray(x), orig, new, lowpass_filter_width=width))


def test_sinc_kernel_bitwise():
    for of, nf, w in ((441, 160, 6), (1, 2, 128)):
        got, gw = res._sinc_kernel(of, nf, w, 0.99)
        want, ww = jres._sinc_kernel(of, nf, w, 0.99)
        assert gw == ww
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# ops/brain_preproc.py
# ---------------------------------------------------------------------------


def test_preprocess_exact():
    x = _normal(7, (3, 5000))
    _close(bp.preprocess_exact(torch.from_numpy(x), 500.0, 1.0, 60.0, down=500 / 120),
           jbp.preprocess_exact(jnp.asarray(x), 500.0, 1.0, 60.0, down=500 / 120))


@pytest.mark.parametrize("lengths,align", [([20000, 18500], 1), ([20000, 18500, 9000], 25), ([7, 300], 3)])
def test_pad_plan(lengths, align):
    assert bp._pad_plan(lengths, align) == jbp._pad_plan(lengths, align)


def _both(recs, *args, **kw):
    got = bp.preprocess_batch(recs, *args, device="cpu", **kw)
    want = jbp.preprocess_batch(recs, *args, **kw)
    assert len(got) == len(want) == len(recs)
    return got, want


@pytest.mark.parametrize("case", ["fused_aligned", "exact_grid", "non_aligned", "short_fallback",
                                  "microbatch_1"])
def test_preprocess_batch_routes(case):
    """Every route against JAX's: the fused path at an aligned ratio (two
    microbatches), the exact grid, a ratio whose denominator exceeds 1000
    (exact chain), pads under the filter half-length (exact chain on the
    original recordings), and one recording a microbatch."""
    recs = [_normal(8, (4, 20000)), _normal(9, (4, 18500)), _normal(10, (4, 12000))]
    args = {"fused_aligned": (500.0, 1.0, 60.0, 120.0), "exact_grid": (500.0, 1.0, 60.0, 120.0),
            "non_aligned": (500.0, 1.0, 60.0, 119.987), "short_fallback": (500.0, 0.1, 60.0, 120.0),
            "microbatch_1": (1000.0, 1.0, 60.0, 120.0)}[case]
    kw = {"exact_grid": True} if case == "exact_grid" else {}
    kw["microbatch"] = 1 if case == "microbatch_1" else 2
    got, want = _both(recs, *args, **kw)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        _close(g, w)


def test_preprocess_batch_very_mixed_lengths():
    """A 45x length spread in one bucket: the short recording's share of
    the pad exceeds its own length, so the device pad zero-extends."""
    recs = [_normal(11, (2, 4000)), _normal(12, (2, 180000))]
    got, want = _both(recs, 500.0, 1.0, 60.0, 120.0)
    for g, w in zip(got, want):
        _close(g, w)


def test_preprocess_batch_quantization_tail():
    """Lengths that are not multiples of Q=4096, one of them shorter than its
    quantization extension (extended with the edge value)."""
    recs = [_normal(13, (2, 30001)), _normal(14, (2, 1500))]
    got, want = _both(recs, 500.0, 1.0, 60.0, 120.0)
    for g, w in zip(got, want):
        _close(g, w)


def test_preprocess_batch_device_resident():
    recs = [_normal(15, (2, 20000)), _normal(16, (2, 11000))]
    dev = bp.preprocess_batch(recs, 500.0, 1.0, 60.0, 120.0, to_host=False, device="cpu")
    host = bp.preprocess_batch(recs, 500.0, 1.0, 60.0, 120.0, device="cpu")
    want = jbp.preprocess_batch(recs, 500.0, 1.0, 60.0, 120.0, to_host=False)
    for d, h, w in zip(dev, host, want):
        assert isinstance(d, torch.Tensor) and d.is_contiguous()
        np.testing.assert_array_equal(d.numpy(), h)
        _close(d, w)


@pytest.mark.parametrize("transfer_dtype", ["int16", "bfloat16"])
def test_quantized_transfer(transfer_dtype):
    """The dequantized transfer equals JAX's bit for bit (same host
    quantization, same f32 dequantization); the outputs match JAX's at the
    f32 tolerance and the f32 route's within the JAX test's quantization
    bounds (tests/test_ops.py:472-473)."""
    amps = np.array([[1.0], [50.0], [2e3], [1e-3]], np.float32)
    recs = [_normal(17, (4, 20000)) * amps, _normal(18, (4, 12000)) * amps]
    for r in recs:
        np.testing.assert_array_equal(bp._ship_raw(r, transfer_dtype, CPU).numpy(),
                                      np.asarray(jbp._ship_raw(r, transfer_dtype)))
    got, want = _both(recs, 500.0, 1.0, 60.0, 120.0, transfer_dtype=transfer_dtype)
    f32 = bp.preprocess_batch(recs, 500.0, 1.0, 60.0, 120.0, device="cpu")
    bound = 2e-4 if transfer_dtype == "int16" else 6e-3
    for g, w, a in zip(got, want, f32):
        scale = np.abs(a).max(axis=-1, keepdims=True)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=ATOL)
        np.testing.assert_allclose(g / scale, a / scale, atol=bound)


def test_bf16_rounding_is_ml_dtypes():
    """The host-side bf16 cast rounds to nearest even, as ml_dtypes does."""
    r = _normal(19, (4, 50000)) * np.float32(1e3)
    r[0, :4] = [1.00390625, 1.01171875, -1.00390625, 3.0e38]  # exact ties, a large value
    got = bp._quantize_host(r, "bfloat16")[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(r, ml_dtypes.bfloat16).view(np.int16))


def test_int16_payload_and_zero_channel():
    r = _normal(20, (3, 5000)) * np.float32(40.0)
    r[1] = 0.0
    q, scale = bp._quantize_host(r, "int16")
    assert q.dtype == torch.int16 and scale.dtype == torch.float32
    assert float(scale[1, 0]) == 1.0 and not bool(q[1].any())
    np.testing.assert_array_equal(np.asarray(jbp._ship_raw(r, "int16")), bp._ship_raw(r, "int16", CPU).numpy())
    with pytest.raises(ValueError, match="transfer_dtype"):
        bp._quantize_host(r, "float16")


def test_preprocess_batch_empty_and_default_device():
    assert bp.preprocess_batch([], 500.0, 1.0, 60.0, 120.0, device="cpu") == []
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bp.preprocess_batch([_normal(21, (2, 1000))], 500.0, 1.0, 60.0, 120.0)


# ---------------------------------------------------------------------------
# frozen goldens (tests/golden/dsp_golden.npz, the JAX test's tolerances)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["gwilliams", "brennan"])
def test_filter_and_resample_match_golden(case):
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "dsp_golden.npz"))
    sfreq, l_freq, h_freq, new_rate = golden[f"{case}_meta"]
    taps = fir.design_bandpass_fir(sfreq, l_freq, h_freq)
    np.testing.assert_allclose(taps, golden[f"{case}_taps"], atol=1e-10)
    filt = fir.fir_filter_zero_phase(torch.from_numpy(golden[f"{case}_input"]), taps)
    np.testing.assert_allclose(filt.numpy(), golden[f"{case}_filtered"], rtol=2e-4, atol=2e-4)
    out = res.fft_resample(filt, up=new_rate, down=sfreq)
    np.testing.assert_allclose(out.numpy(), golden[f"{case}_resampled"], rtol=2e-4, atol=2e-4)
