"""The host-side preparation of K4's routes (``ops.conv_block``), on CPU
tensors at small widths: the bf16 weight images the wgmma route reads (conv0
and conv1 K-major through ``tap_conv.pack_weights``, conv2 GLU-interleaved
through ``glu_pack``), applied by a plain torch conv
(``F.conv1d``) against the plain version's convs; conv0's zero depth
padding; the staged tuple (``prepare_fused_stack`` on the port's
``ConvBlock``) against the JAX Pallas ``conv_block_fused`` in interpret mode;
the bf16 tuple read back by ``conv_block_plain`` bit for bit as the same
values staged in f32; and the route rule. Convs compare in f32 at rtol
and atol 1e-5 (sums of ~100 products of order 1 in another order); the
block against JAX at rtol 1e-4, atol 1e-5, as tests/test_torch_ops.py
holds the plain version."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.nn import functional as Fn  # noqa: E402

from speech_decoding_tpu.ops.pallas import conv_block as jcb  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import ConvBlock  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block as tcb  # noqa: E402
from speech_decoding_tpu_torch.ops.tap_conv import conv3  # noqa: E402

torch.set_num_threads(1)

T = 40


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _bf16_values(t):
    """t rounded to bf16 and back: staging in bf16 then keeps its values exactly."""
    return t.bfloat16().float()


def _conv1d_on_image(x, wk, d):
    """F.conv1d of x (B, T, Cin) with a K-major image wk (3, N, Cin8): the
    image permuted to (N, Cin8, 3) is conv1d's weight, x's channels
    zero-padded to Cin8. Returns (B, T, N) f32."""
    xp = Fn.pad(x, (0, wk.shape[2] - x.shape[2]))
    return Fn.conv1d(xp.transpose(1, 2), wk.float().permute(1, 2, 0), dilation=d, padding=d).transpose(1, 2)


@pytest.mark.parametrize("cin,C,d", [(27, 16, 1), (16, 24, 4), (40, 8, 16), (270, 320, 2)])
def test_kmajor_image_reproduces_the_plain_conv(cin, C, d):
    """conv0's and conv1's bf16 image, applied by F.conv1d, gives the plain
    version's conv of the same weights (d=16 reaches past both edges of
    T=40)."""
    rng = np.random.default_rng(cin + C + d)
    x = _rand(rng, 2, T, cin)
    w = _bf16_values(_rand(rng, 3, cin, C) / np.sqrt(3 * cin))
    wk = tcb.stage_weight(w, torch.bfloat16)
    assert wk.dtype == torch.bfloat16 and wk.shape == (3, C, tcb.conv0_depth(cin, torch.bfloat16))
    torch.testing.assert_close(_conv1d_on_image(x, wk, d), conv3(x, w, d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,d", [(16, 2), (8, 16), (320, 2)])
def test_glu_image_reproduces_the_plain_conv(C, d):
    """conv2's bf16 image interleaves each channel's value and gate rows:
    F.conv1d with it, de-interleaved, gives the plain version's (value |
    gate) conv."""
    rng = np.random.default_rng(C + d)
    h = _rand(rng, 2, T, C)
    w2 = _bf16_values(_rand(rng, 3, C, 2 * C) / np.sqrt(3 * C))
    w2g = tcb.stage_weight(w2, torch.bfloat16, glu=True)
    assert w2g.shape == (3, 2 * C, C) and w2g.is_contiguous()
    y = _conv1d_on_image(h, w2g, d)
    torch.testing.assert_close(torch.cat([y[..., 0::2], y[..., 1::2]], -1), conv3(h, w2, d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin", [13, 16, 270])
def test_conv0_depth_padding_is_zero(cin):
    """The image's depth is Cin rounded up to a multiple of 8 and the padding
    columns are zero; plain_weight reads every staged weight back bit for
    bit; the f32 staging is a fresh copy in the reference layout."""
    rng = np.random.default_rng(cin)
    w0, w2 = _rand(rng, 3, cin, 24), _rand(rng, 3, 24, 48)
    wk = tcb.stage_weight(w0, torch.bfloat16)
    cin8 = -(-cin // 8) * 8
    assert tcb.conv0_depth(cin, torch.bfloat16) == cin8 and wk.shape == (3, 24, cin8)
    assert not wk[..., cin:].any() and wk.data_ptr() % 16 == 0
    assert torch.equal(tcb.plain_weight(wk, cin), w0.bfloat16())
    assert torch.equal(tcb.plain_weight(tcb.stage_weight(w2, torch.bfloat16, glu=True), 24, glu=True), w2.bfloat16())
    w32 = tcb.stage_weight(w0, torch.float32)
    assert torch.equal(w32, w0) and w32.data_ptr() != w0.data_ptr() and tcb.conv0_depth(cin, torch.float32) == cin
    assert tcb.plain_weight(w32, cin) is w32


def _block(k, cin, D2, seed):
    """A port ConvBlock with random BatchNorm parameters and statistics."""
    blk = ConvBlock(k, cin, D2, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for bn in (blk.batchnorm0, blk.batchnorm1):
            bn.scale.copy_(0.5 + torch.rand(D2, generator=g))
            bn.bias.copy_(0.1 * torch.randn(D2, generator=g))
            bn.mean.copy_(0.2 * torch.randn(D2, generator=g))
            bn.var.copy_(0.5 + 1.5 * torch.rand(D2, generator=g))
    return blk.eval()


def _jax_args(blk):
    """The block's weights, biases and folded BN affines as the JAX kernel takes them."""
    def n(t):
        return jnp.asarray(t.detach().numpy())

    folds = [jcb.fold_bn({"scale": bn.scale.detach().numpy(), "bias": bn.bias.detach().numpy()},
                         {"mean": bn.mean.numpy(), "var": bn.var.numpy()})
             for bn in (blk.batchnorm0, blk.batchnorm1)]
    return (n(blk.conv0.kernel), n(blk.conv0.bias), jnp.asarray(folds[0]), n(blk.conv1.kernel),
            n(blk.conv1.bias), jnp.asarray(folds[1]), n(blk.conv2.kernel), n(blk.conv2.bias))


@pytest.mark.parametrize("k", range(5))
def test_staged_tuple_matches_pallas(k):
    """prepare_fused_stack's f32 tuple of a port ConvBlock, through
    conv_block_fused (the plain version on the CPU), against the JAX Pallas
    kernel in interpret mode on the same weights and statistics; block 0
    takes 13 input channels (not a multiple of 8)."""
    cin, D2 = (13 if k == 0 else 16), 16
    blk = _block(k, cin, D2, seed=k)
    x = np.random.default_rng(20 + k).normal(size=(2, T, cin)).astype(np.float32)
    staged = tcb.prepare_fused_stack([blk], torch.float32)[0]
    with torch.no_grad():  # the staged f32 biases are the module's parameters
        got = tcb.conv_block_fused(torch.from_numpy(x), *staged, k=k)
    want = np.asarray(jcb.conv_block_fused(jnp.asarray(x), *_jax_args(blk), k=k, interpret=True))
    assert got.shape == (2, T, D2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", range(5))
def test_bf16_staged_tuple_reads_as_the_f32_one(k):
    """The bf16 tuple (K-major images) gives conv_block_plain the bits of
    the f32 tuple of the same bf16 weight values, and the module block's eval
    forward within bf16 rounding (a flipped rounding of h0 or h1: 1e-2)."""
    cin, D2 = (27 if k == 0 else 24), 24
    blk = _block(k, cin, D2, seed=10 + k)
    with torch.no_grad():
        for conv in (blk.conv0, blk.conv1, blk.conv2):
            conv.kernel.copy_(_bf16_values(conv.kernel))
    s16 = tcb.prepare_fused_stack([blk], torch.bfloat16)[0]
    s32 = tcb.prepare_fused_stack([blk], torch.float32)[0]
    assert s16[0].shape == (3, D2, -(-cin // 8) * 8) and s16[6].shape == (3, 2 * D2, D2)
    x = _rand(np.random.default_rng(30 + k), 2, T, cin).bfloat16()
    with torch.no_grad():
        got = tcb.conv_block_fused(x, *s16, k=k)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, tcb.conv_block_plain(x, *s32, k=k))
        torch.testing.assert_close(got.float(), blk(x.float()), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype,D2,want", [(torch.float32, 20, "f32"), (torch.bfloat16, 320, "wgmma"),
                                           (torch.bfloat16, 48, "wgmma"), (torch.bfloat16, 20, ValueError),
                                           (torch.float16, 320, TypeError)])
def test_route_rule(dtype, D2, want):
    """bf16 with D2 % 8 == 0 takes wgmma, f32 the CUDA-core body; any other
    input raises (no fallback)."""
    if isinstance(want, str):
        assert tcb._route(dtype, D2) == want
    else:
        with pytest.raises(want):
            tcb._route(dtype, D2)


def test_cpu_call_launches_nothing():
    blk = _block(1, 16, 16, seed=3)
    staged = tcb.prepare_fused_stack([blk], torch.bfloat16)[0]
    before, route = tcb.conv_block_fused.launches, tcb.conv_block_fused.route
    with torch.no_grad():
        out = tcb.conv_block_fused(torch.zeros(1, 5, 16, dtype=torch.bfloat16), *staged, k=1)
    assert out.shape == (1, 5, 16)
    assert (tcb.conv_block_fused.launches, tcb.conv_block_fused.route) == (before, route)
