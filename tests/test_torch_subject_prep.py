"""The host-side preparation of K1's ``wgmma`` route (``ops.subject_conv``),
on CPU tensors: the weight image (``pack_weights``, forward and the dX's
Wᵀ) against ``Fn.pad`` of W and Wᵀ, the pack cache (``packed_weights``),
the domain rule that picks the route (``_fast_path``) and the host-side id
check. The product
read through the image equals JAX's Pallas ``subject_matmul`` in interpret
mode (f32, atol 1e-5 on values of order 10)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.nn import functional as Fn  # noqa: E402

from speech_decoding_tpu.ops.pallas.subject_conv import subject_matmul as j_subject_matmul  # noqa: E402
from speech_decoding_tpu_torch.ops import subject_conv as sc  # noqa: E402

torch.set_num_threads(1)

NP = sc.WG_CHANNELS  # 272 output channels in the image


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _unpack(img):
    """(S, 17, 34, 2, 8, 8) -> the padded (S, 272, 272) it was packed from."""
    S, steps = img.shape[:2]
    return img.permute(0, 1, 3, 5, 2, 4).reshape(S, 16 * steps, NP)


@pytest.mark.parametrize("s,k,n", [(27, 270, 270), (4, 19, 150), (2, 16, 272), (1, 1, 1), (3, 40, 24)])
@pytest.mark.parametrize("transposed", [False, True])
def test_pack_against_pad(s, k, n, transposed):
    """Every entry of the image is the padded W (or Wᵀ) at [16j + 8h + e,
    8g + r]; zeros in the padding, values in place."""
    w = _rand(np.random.default_rng(k + n), s, *((n, k) if transposed else (k, n)))
    wk = w.transpose(1, 2) if transposed else w
    img = sc.pack_weights(w, transposed)
    assert img.shape == (s, NP // 16, NP // 8, 2, 8, 8) and img.is_contiguous()
    want = Fn.pad(wk, (0, NP - n, 0, NP - k))
    assert torch.equal(_unpack(img), want)
    j, g, h, r, e = 1, 1, 1, 3, 5
    kk, nn = 16 * j + 8 * h + e, 8 * g + r
    assert img[0, j, g, h, r, e] == (wk[0, kk, nn] if kk < k and nn < n else 0)


def test_pack_refuses_too_many_channels():
    for shape in ((1, 8, NP + 2), (1, NP + 16, 8)):
        with pytest.raises(ValueError, match="at most 272"):
            sc.pack_weights(torch.zeros(shape))


def test_pack_cache_hits_and_misses():
    """The same tensor packs once; an in-place update or a new tensor packs
    again; the two directions are kept apart."""
    w = _rand(np.random.default_rng(0), 3, 24, 40)
    first = sc.packed_weights(w)
    assert sc.packed_weights(w) is first
    t_first = sc.packed_weights(w, transposed=True)
    assert t_first is not first and sc.packed_weights(w, transposed=True) is t_first
    assert sc.packed_weights(w) is first  # the other direction's entry stays
    w.add_(1)
    again = sc.packed_weights(w)
    assert again is not first and torch.equal(again, sc.pack_weights(w))
    assert not torch.equal(again, first)
    fresh = w.clone()
    other = sc.packed_weights(fresh)
    assert other is not again and torch.equal(other, again)
    assert sc.packed_weights(w) is not other  # back to w: a new object again


def test_pack_cache_skips_inference_tensors():
    with torch.inference_mode():
        w = torch.ones(2, 16, 16)
        assert sc.packed_weights(w) is not sc.packed_weights(w)


@pytest.mark.parametrize("shape,ptr,want", [
    ((64, 360, 270, 270), 0, True),        # the flagship forward and dX
    ((1024, 360, 270, 270), 256, True),     # the eval chunk
    ((3, 37, 19, 150), 0, False),           # ragged: odd D_in, rows of 38 bytes
    ((64, 360, 270, 270), 2, False),        # a base one element past an allocation
    ((64, 360, 270, 270), 8, False),        # 8 bytes in: bulk copies need 16
    ((2, 70, 24, 344), 0, False),           # more than 272 output channels
    ((4, 37, 270, 270), 0, False),          # T·D_in % 8 != 0: tile runs misaligned
    ((4, 36, 270, 270), 0, True),
    ((1, 1, 1, 1), 0, False),
    ((0, 360, 270, 270), 0, False),         # nothing to compute
    ((2, 8, 272, 272), 0, True),
    ((2, 8, 288, 270), 0, False),           # D_in past the 17 reduction steps
    ((2, 8, 270, 269), 0, False),           # odd D_out: no 4-byte column pairs
    ((2, 1, 8, 2), 0, False),               # T·D_out % 8 != 0: output runs misaligned
])
def test_fast_path_domain(shape, ptr, want):
    assert sc._fast_path(*shape, ptr) is want


def test_product_through_the_image_matches_jax():
    """The wgmma route's arithmetic on the CPU: x (zero past D_in) against the
    image unpacked, f32, forward and dX, against JAX's Pallas kernel in
    interpret mode and its VJP's dX."""
    import jax

    rng = np.random.default_rng(5)
    b, t, din, dout, s = 4, 12, 30, 22, 3
    x = rng.normal(size=(b, t, din)).astype(np.float32)
    w = rng.normal(size=(s, din, dout)).astype(np.float32)
    g = rng.normal(size=(b, t, dout)).astype(np.float32)
    ids = np.array([2, 0, 1, 2], np.int32)
    tx, tw, tg, tids = (torch.from_numpy(a) for a in (x, w, g, ids))
    wpad = _unpack(sc.pack_weights(tw))  # (S, 272, 272)
    got = torch.einsum("bti,bio->bto", Fn.pad(tx, (0, wpad.shape[1] - din)), wpad[tids.long()])[..., :dout]
    want = np.asarray(j_subject_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids), True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wtpad = _unpack(sc.pack_weights(tw, transposed=True))  # Wᵀ: (S, 272, 272)
    got_dx = torch.einsum("bto,boi->bti", Fn.pad(tg, (0, wtpad.shape[1] - dout)), wtpad[tids.long()])[..., :din]
    _, vjp = jax.vjp(lambda a: j_subject_matmul(a, jnp.asarray(w), jnp.asarray(ids), True), jnp.asarray(x))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", [-1, 4])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_host_ids_checked_without_a_device(bad, dtype):
    """Host ids outside [0, S) raise before anything reaches a device."""
    ids = torch.tensor([0, bad, 1], dtype=dtype)
    with pytest.raises(ValueError, match=r"subject ids must lie in \[0, 4\)"):
        sc.check_host_ids(ids.numpy(), 4)
    with pytest.raises(ValueError, match="subject ids"):
        sc.subject_matmul(torch.zeros(3, 2, 8), torch.zeros(4, 8, 8), ids)
    sc.check_host_ids(np.array([0, 3, 3]), 4)
    sc.check_host_ids(np.array([], np.int32), 4)
