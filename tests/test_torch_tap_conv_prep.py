"""The host-side preparation of K2's and K5's operands (``ops.tap_conv``):
``pad_channels`` (channels zero-padded to a multiple of 8, misaligned bases
copied) and ``pack_weights`` (K5's K-major weights, forward and dx), on CPU
tensors, and the CPU path of ``tap_conv_transposed`` (K5's dx). At small B and narrow widths for each flagship dilation, the plain
version on the prepared operands, sliced back, equals the plain version on
the originals, and both equal JAX's Pallas ``tap_conv`` / ``tap_conv_dw``
in interpret mode (f32, rtol 1e-5; atol 1e-5 for the conv, 1e-4 for the
weight gradients, sums of ~100 products of order 1)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.ops.pallas.tap_conv import tap_conv as j_tap_conv  # noqa: E402
from speech_decoding_tpu.ops.pallas.tap_conv import tap_conv_dw as j_tap_conv_dw  # noqa: E402
from speech_decoding_tpu_torch.ops.tap_conv import (  # noqa: E402
    flip_taps, pack_weights, pad_channels, tap_conv_dw_plain, tap_conv_plain, tap_conv_transposed,
)

torch.set_num_threads(1)

DILATIONS = [1, 2, 4, 8, 16]  # every dilation of the flagship's k=3 convs
T = 40


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("c,want", [(270, 272), (272, 272), (320, 320), (1, 8), (13, 16)])
def test_pad_channels_widths(c, want):
    x = _rand(np.random.default_rng(c), 2, 3, c)
    p = pad_channels(x)
    assert p.shape == (2, 3, want) and p.is_contiguous() and p.data_ptr() % 16 == 0
    assert torch.equal(p[..., :c], x) and not p[..., c:].any()
    assert (p is x) == (c == want)  # no copy when TMA can read x as it is


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_channels_copies_a_misaligned_base(dtype):
    flat = torch.arange(2 * 5 * 16 + 1, dtype=torch.float32).to(dtype)
    x = flat[1:].view(2, 5, 16)
    assert x.data_ptr() % 16
    p = pad_channels(x)
    assert p.data_ptr() % 16 == 0 and p.data_ptr() != x.data_ptr() and torch.equal(p, x)


@pytest.mark.parametrize("cin,cout", [(270, 320), (320, 270), (12, 10)])
def test_pack_weights_forward_and_dx(cin, cout):
    """Forward: (3, Cout, Cin8) with [j, co, ci] = w[j, ci, co]. dx: the
    packed form of flip_taps(w) is w.flip(0), padded, which the transposed
    packing makes in one step."""
    w = _rand(np.random.default_rng(cin + cout), 3, cin, cout)
    wk = pack_weights(w)
    cin8 = -(-cin // 8) * 8
    assert wk.shape == (3, cout, cin8) and wk.is_contiguous()
    assert torch.equal(wk[:, :, :cin], w.transpose(1, 2)) and not wk[:, :, cin:].any()
    assert torch.equal(pack_weights(flip_taps(w)), pad_channels(w.flip(0)))
    assert torch.equal(pack_weights(w, transposed=True), pack_weights(flip_taps(w)))


@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("cin,cout", [(13, 10), (16, 12)])
def test_conv_on_prepared_operands(d, cin, cout):
    """K5 forward and dx as the kernel reads them: x padded, weights packed
    (the plain version on the packed weights transposed back), sliced back."""
    rng = np.random.default_rng(10 * d + cin)
    x = _rand(rng, 3, T, cin)
    w = 0.2 * _rand(rng, 3, cin, cout)
    gy = _rand(rng, 3, T, cout)
    want = tap_conv_plain(x, w, d)
    got = tap_conv_plain(pad_channels(x), pack_weights(w).transpose(1, 2), d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jax_y = np.asarray(j_tap_conv(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), d, interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_y, rtol=1e-5, atol=1e-5)
    # dx: K5 on flip_taps(w), as PallasTapConv's backward calls it
    wt = flip_taps(w)
    want_dx = tap_conv_plain(gy, wt, d)
    got_dx = tap_conv_plain(pad_channels(gy), pack_weights(w, transposed=True).transpose(1, 2), d)[..., :cin]
    assert got_dx.shape == (3, T, cin)
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tap_conv_transposed(gy, w, d), want_dx, rtol=0, atol=0)
    jax_dx = np.asarray(j_tap_conv(jnp.asarray(gy.numpy()), jnp.asarray(wt.numpy()), d, interpret=True))
    np.testing.assert_allclose(got_dx.numpy(), jax_dx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("cin,cout", [(13, 10), (16, 12)])
def test_dw_on_prepared_operands(d, cin, cout):
    """K2 as the kernel reads x and g: both padded; dW sliced back to
    (3, Cin, Cout); the padded rows and columns are zero."""
    rng = np.random.default_rng(20 * d + cin)
    x = _rand(rng, 3, T, cin)
    g = _rand(rng, 3, T, cout)
    want = tap_conv_dw_plain(x, g, d)
    full = tap_conv_dw_plain(pad_channels(x), pad_channels(g), d)
    assert not full[:, cin:].any() and not full[:, :, cout:].any()
    got = full[:, :cin, :cout]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jax_dw = np.asarray(j_tap_conv_dw(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), d, interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_dw, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(3, 12, 10), (3, 10, 12), (2, 10, 10)])
def test_tap_conv_transposed_checks_shapes(shape):
    """x (B, T, Cout) against w (3, Cin, Cout): only (3, *, 10) fits."""
    x = torch.zeros(2, T, 10)
    w = torch.zeros(shape)
    if shape[0] == 3 and shape[2] == 10:
        assert tap_conv_transposed(x, w, 2).shape == (2, T, shape[1])
    else:
        with pytest.raises(ValueError, match="tap_conv shapes"):
            tap_conv_transposed(x, w, 2)
