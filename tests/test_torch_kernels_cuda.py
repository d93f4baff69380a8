"""The hand-written CUDA kernels (K1 forward and backward, K2, K3, K4, K5,
the six stages of K6 and K7) against their plain PyTorch versions, on the card;
then the device-resident gather against the host batches and a tiny CLI run. Marked ``cuda``; each test skips when no CUDA device is present (the
CPU tier holds the plain versions against JAX instead). Run on a GPU with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.ops import conv_block as tcb  # noqa: E402
from speech_decoding_tpu_torch.ops.retrieval import (  # noqa: E402
    near_tie_rows, retrieval_ranks, retrieval_ranks_plain,
)
from speech_decoding_tpu_torch.ops import subject_conv as sc  # noqa: E402
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul, subject_matmul_plain  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block_train as cbt  # noqa: E402
from speech_decoding_tpu_torch.ops.tap_conv import (  # noqa: E402
    PallasTapConv, flip_taps, tap_conv, tap_conv_dw, tap_conv_dw_plain, tap_conv_plain, tap_conv_transposed,
)

pytestmark = pytest.mark.cuda

# f32: both sides accumulate in f32, only the order differs. bf16: outputs
# (and the kernel's y0/y1) round to bf16, so a flipped rounding is one ulp.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, scale=1.0):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol * scale, rtol=rtol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 360, 270, 270, 27), (3, 37, 19, 150, 4), (1, 1, 1, 1, 1), (2, 70, 24, 344, 2)])
def test_subject_matmul_kernel(dev, dtype, shape):
    B, T, Din, Dout, S = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, Din, device=dev, generator=g).to(dtype)
    w = torch.randn(S, Din, Dout, device=dev, generator=g).div(Din ** 0.5).to(dtype)
    ids = torch.randint(0, S, (B,), device=dev, generator=g, dtype=torch.int32)
    before = subject_matmul.launches
    got = subject_matmul(x, w, ids)
    assert subject_matmul.launches == before + 1
    _close(got, subject_matmul_plain(x, w, ids), dtype)


def test_subject_matmul_kernel_rejects(dev):
    x = torch.zeros(2, 3, 8, device=dev)
    w = torch.zeros(2, 8, 8, device=dev)
    ids = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        subject_matmul(x.half(), w.half(), ids)
    with pytest.raises(TypeError):
        subject_matmul(x, w, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        subject_matmul(x.transpose(0, 1).contiguous().transpose(0, 1), w, ids)
    with pytest.raises(ValueError, match="subject ids"):
        subject_matmul(x, w, ids + 2)


def _staged(dev, cin, d2, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    aff = lambda: torch.stack([0.5 + torch.rand(d2, device=dev, generator=g), 0.1 * r(d2)])  # noqa: E731
    return (
        tcb.stage_weight(r(3, cin, d2) / (3 * cin) ** 0.5, dtype), 0.1 * r(d2), aff(),
        tcb.stage_weight(r(3, d2, d2) / (3 * d2) ** 0.5, dtype), 0.1 * r(d2), aff(),
        tcb.stage_weight(r(3, d2, 2 * d2) / (3 * d2) ** 0.5, dtype, glu=True), 0.1 * r(2 * d2),
    )


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D1,D2", [(2, 360, 270, 320), (3, 37, 40, 48), (2, 5, 16, 16)])
def test_conv_block_kernel(dev, k, dtype, B, T, D1, D2):
    """Each block against its plain version; bf16 takes the wgmma route
    (three conv_wg launches counted as one), f32 the CUDA-core body. T=37
    and T=5 put every dilation past both edges of the recording."""
    cin = D1 if k == 0 else D2
    args = _staged(dev, cin, D2, dtype, seed=k)
    x = torch.randn(B, T, cin, device=dev).to(dtype)
    before = tcb.conv_block_fused.launches
    got = tcb.conv_block_fused(x, *args, k=k)
    assert tcb.conv_block_fused.launches == before + 1
    assert tcb.conv_block_fused.route == ("wgmma" if dtype == torch.bfloat16 else "f32")
    _close(got, tcb.conv_block_plain(x, *args, k=k), dtype, scale=1.0 if dtype == torch.bfloat16 else 10.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [0, 3])
def test_conv_block_kernel_is_deterministic(dev, dtype, k):
    """Two runs on the same inputs give the same bits (no atomics on either route)."""
    cin = 270 if k == 0 else 320
    args = _staged(dev, cin, 320, dtype, seed=7 + k)
    x = torch.randn(8, 360, cin, device=dev).to(dtype)
    a, b = tcb.conv_block_fused(x, *args, k=k), tcb.conv_block_fused(x, *args, k=k)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_conv_block_kernel_rejects(dev):
    args = _staged(dev, 16, 16, torch.float32, seed=0)
    x = torch.zeros(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="argument 1"):
        tcb.conv_block_fused(x, args[0].bfloat16(), *args[1:], k=0)
    with pytest.raises(ValueError, match="Cin must equal D2"):
        bad = _staged(dev, 8, 16, torch.float32, seed=0)
        tcb.conv_block_fused(torch.zeros(2, 8, 8, device=dev), *bad, k=1)
    with pytest.raises(TypeError):
        tcb.conv_block_fused(x.half(), *args, k=0)
    # a contiguous view that starts 4 bytes into its allocation: the wrapper realigns it
    xs = torch.randn(2 * 8 * 16 + 1, device=dev)[1:].view(2, 8, 16)
    assert xs.data_ptr() % 16
    torch.testing.assert_close(tcb.conv_block_fused(xs, *args, k=0), tcb.conv_block_plain(xs, *args, k=0),
                               atol=1e-4, rtol=1e-4)
    # the bf16 route's rows are 16 bytes: D2 = 20 raises, it does not fall back
    odd = _staged(dev, 24, 20, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="D2 % 8"):
        tcb.conv_block_fused(torch.zeros(2, 8, 24, device=dev, dtype=torch.bfloat16), *odd, k=0)
    # bf16 weights must come staged: the K-major images, 16-byte aligned
    raw = [a.bfloat16() if a.dim() == 3 else a for a in _staged(dev, 24, 16, torch.float32, seed=0)]
    x16 = torch.zeros(2, 8, 24, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="argument 1"):
        tcb.conv_block_fused(x16, *raw, k=0)
    staged = list(_staged(dev, 24, 16, torch.bfloat16, seed=0))
    w0 = staged[0]
    staged[0] = torch.zeros(w0.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(w0.shape).copy_(w0)
    with pytest.raises(ValueError, match="aligned"):
        tcb.conv_block_fused(x16, *staged, k=0)
    # a misaligned bf16 x is copied (as block 0's 270 channels are padded) and must match
    x16 = torch.randn(2, 8, 24, device=dev).bfloat16()
    xm = torch.zeros(x16.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(x16.shape).copy_(x16)
    staged[0] = w0
    torch.testing.assert_close(tcb.conv_block_fused(xm, *staged, k=0), tcb.conv_block_fused(x16, *staged, k=0),
                               atol=0, rtol=0)


def test_subject_matmul_kernel_realigns_views(dev):
    """A contiguous view that starts 2 bytes into its allocation is copied to
    an aligned buffer first: same answer as the plain version."""
    g = torch.Generator(device=dev).manual_seed(1)
    flat = torch.randn(4 * 9 * 24 + 1, device=dev, generator=g).to(torch.bfloat16)
    x = flat[1:].view(4, 9, 24)
    assert x.data_ptr() % 16
    w = torch.randn(3, 24, 40, device=dev, generator=g).to(torch.bfloat16)
    ids = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device=dev)
    _close(subject_matmul(x, w, ids), subject_matmul_plain(x, w, ids), torch.bfloat16)


def test_subject_matmul_kernel_takes_host_ids(dev):
    """Host ids are checked on the host and copied over with the launch."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(4, 9, 24, device=dev, generator=g)
    w = torch.randn(3, 24, 40, device=dev, generator=g)
    ids = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    before = subject_matmul.launches
    got = subject_matmul(x, w, ids)
    assert subject_matmul.launches == before + 1
    _close(got, subject_matmul_plain(x, w, ids.to(dev)), torch.float32)
    with pytest.raises(ValueError, match="subject ids"):
        subject_matmul(x, w, ids + 1)


def _close_scaled(got, want, rel):
    """|got - want| <= rel·max|want| + rel·|want|: for sums whose terms
    cancel, the rounding of the order scales with the largest entry."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    bound = rel * float(w.abs().max()) + rel * w.abs()
    assert bool(torch.isfinite(g).all())
    assert bool(((g - w).abs() <= bound).all()), float(((g - w).abs() - bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 360, 270, 270, 27), (3, 37, 19, 150, 4)])
def test_subject_matmul_backward(dev, dtype, shape):
    """dX through the kernel on Wᵀ and dW by segment sum, against the plain
    version's autograd grads. f32 1e-5 of the largest entry; bf16 1e-2 (the
    outputs round to bf16, a flipped rounding is one ulp)."""
    B, T, Din, Dout, S = shape
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(B, T, Din, device=dev, generator=g).to(dtype)
    w = torch.randn(S, Din, Dout, device=dev, generator=g).div(Din ** 0.5).to(dtype)
    gy = torch.randn(B, T, Dout, device=dev, generator=g).to(dtype)
    ids = torch.randint(0, S, (B,), device=dev, generator=g, dtype=torch.int32)
    grads = []
    for fn in (subject_matmul, subject_matmul_plain):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xa, wa, ids).backward(gy)
        grads.append((xa.grad, wa.grad))
    before = subject_matmul.launches
    subject_matmul(x.requires_grad_(), w, ids).backward(gy)
    assert subject_matmul.launches == before + 2  # forward and dX
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in zip(grads[0], grads[1]):
        assert got.dtype == dtype
        _close_scaled(got, want, rel)


def _misaligned(t):
    """A contiguous copy of ``t`` whose base lies one element past an allocation's start."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def _k1_inputs(dev, B, T, Din, Dout, S, seed, ids=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, Din, device=dev, generator=g).bfloat16()
    w = torch.randn(S, Din, Dout, device=dev, generator=g).div(Din ** 0.5).bfloat16()
    if ids is None:
        ids = torch.randint(0, S, (B,), device=dev, generator=g, dtype=torch.int32)
    return x, w, ids


@pytest.mark.parametrize("B", [64, 1024])
def test_subject_matmul_wgmma_route(dev, B):
    """The flagship (B=64) and the eval chunk (B=1024) take the wgmma body;
    bf16 against the plain version at 1e-2."""
    x, w, ids = _k1_inputs(dev, B, 360, 270, 270, 27, seed=B)
    before = subject_matmul.launches
    got = subject_matmul(x, w, ids)
    assert subject_matmul.launches == before + 1 and subject_matmul.route == "wgmma"
    _close(got, subject_matmul_plain(x, w, ids), torch.bfloat16)


@pytest.mark.parametrize("case", ["one odd subject", "all distinct"])
def test_subject_matmul_wgmma_ids(dev, case):
    """Every row on subject 13 (an odd subject: its weights start at an odd
    multiple of 145,800 bytes in W); every row on a different subject."""
    if case == "one odd subject":
        x, w, ids = _k1_inputs(dev, 64, 360, 270, 270, 27, seed=5,
                               ids=torch.full((64,), 13, dtype=torch.int32, device=dev))
    else:
        perm = torch.randperm(27, generator=torch.Generator().manual_seed(6)).to(dev, torch.int32)
        x, w, ids = _k1_inputs(dev, 27, 360, 270, 270, 27, seed=6, ids=perm)
    got = subject_matmul(x, w, ids)
    assert subject_matmul.route == "wgmma"
    _close(got, subject_matmul_plain(x, w, ids), torch.bfloat16)


def test_subject_matmul_misaligned_and_ragged(dev):
    """A misaligned x takes the wmma body (copied first), a misaligned W the
    wgmma body (the pack reads it element by element), a misaligned g the
    wmma body for dX; the ragged shape the wmma body. All match the plain
    version."""
    x, w, ids = _k1_inputs(dev, 8, 360, 270, 270, 27, seed=7)
    want = subject_matmul_plain(x, w, ids)
    for xx, ww, route in ((_misaligned(x), w, "wmma"), (x, _misaligned(w), "wgmma")):
        got = subject_matmul(xx, ww, ids)
        assert subject_matmul.route == route
        _close(got, want, torch.bfloat16)
    gy = torch.randn(8, 360, 270, device=dev).bfloat16()
    xa = x.clone().requires_grad_()
    subject_matmul(xa, w, ids).backward(_misaligned(gy))
    assert subject_matmul.route == "wmma"
    _close(xa.grad, subject_matmul_plain(gy, w.transpose(1, 2), ids), torch.bfloat16)
    x, w, ids = _k1_inputs(dev, 3, 37, 19, 150, 4, seed=8)
    got = subject_matmul(x, w, ids)
    assert subject_matmul.route == "wmma"
    _close(got, subject_matmul_plain(x, w, ids), torch.bfloat16)


def test_subject_matmul_backward_wgmma_route(dev):
    """The flagship's dX through the wgmma body on the packed Wᵀ: two
    launches for forward and backward, both on the new body."""
    x, w, ids = _k1_inputs(dev, 64, 360, 270, 270, 27, seed=9)
    gy = torch.randn(64, 360, 270, device=dev).bfloat16()
    xa = x.clone().requires_grad_()
    before, packs = subject_matmul.launches, sc.packed_weights.packs
    out = subject_matmul(xa, w, ids)
    assert subject_matmul.route == "wgmma"
    out.backward(gy)
    assert subject_matmul.launches == before + 2 and subject_matmul.route == "wgmma"
    assert sc.packed_weights.packs - packs <= 2  # at most one a direction
    _close(xa.grad, subject_matmul_plain(gy, w.transpose(1, 2), ids), torch.bfloat16)


@pytest.mark.parametrize("transposed", [False, True])
def test_subject_matmul_pack_kernel(dev, transposed):
    """The pack kernel writes the plain pack's image bit for bit, from an
    aligned and a misaligned W; the cache hits until W changes in place."""
    _, w, _ = _k1_inputs(dev, 1, 1, 270, 270, 27, seed=10)
    for ww in (w, _misaligned(w)):
        img = sc.packed_weights(ww, transposed)
        torch.cuda.synchronize()
        assert torch.equal(img, sc.pack_weights(ww, transposed))
        assert sc.packed_weights(ww, transposed) is img
    w.mul_(2)
    img = sc.packed_weights(w, transposed)
    assert torch.equal(img, sc.pack_weights(w, transposed))


def test_subject_matmul_host_ids_copied_at_the_call(dev):
    """Host ids reach the card through a pinned copy made at the call: a
    change of the host array afterwards does not reach the launch."""
    x, w, _ = _k1_inputs(dev, 64, 360, 270, 270, 27, seed=11)
    ids = torch.arange(64, dtype=torch.int32) % 27
    want = subject_matmul_plain(x, w, ids.to(dev))
    got = subject_matmul(x, w, ids)
    ids.fill_(0)
    _close(got, want, torch.bfloat16)


def test_subject_matmul_host_ids_ring_wraps(dev):
    """70 calls of 1,000 host ids each run the pinned ring round more than a
    lap (4 segments of 16,384 ids), each host array overwritten right after
    its call: every output is that call's product."""
    x, w, _ = _k1_inputs(dev, 1000, 8, 16, 16, 7, seed=12)
    rng = torch.Generator().manual_seed(12)
    outs, wants = [], []
    ids = torch.empty(1000, dtype=torch.int32)
    for _ in range(70):
        ids.copy_(torch.randint(0, 7, (1000,), generator=rng, dtype=torch.int32))
        wants.append(ids.clone())
        outs.append(subject_matmul(x, w, ids))
        ids.fill_(6)
    for got, want_ids in zip(outs, wants):
        _close(got, subject_matmul_plain(x, w, want_ids.to(dev)), torch.bfloat16)


# (Cin, Cout, dilations) of the flagship's k=3 convs (D1=270, D2=320)
K2_SHAPES = [(270, 320, (1,)), (320, 320, (1, 2, 4, 8, 16)), (320, 640, (2,))]


@pytest.mark.parametrize("cin,cout,dils", K2_SHAPES)
def test_tap_conv_dw_flagship_bf16(dev, cin, cout, dils):
    """bf16 x and g at B=64, T=360: products exact in f32, both sides sum in
    f32 in another order (1e-4 of the largest entry)."""
    g = torch.Generator(device=dev).manual_seed(cin + cout)
    x = torch.randn(64, 360, cin, device=dev, generator=g).bfloat16()
    gy = torch.randn(64, 360, cout, device=dev, generator=g).bfloat16()
    for d in dils:
        before = tap_conv_dw.launches
        got = tap_conv_dw(x, gy, d)
        assert tap_conv_dw.launches == before + 1 and got.shape == (3, cin, cout) and got.dtype == torch.float32
        _close_scaled(got, tap_conv_dw_plain(x, gy, d), 1e-4)


@pytest.mark.parametrize("B,T,cin,cout,d", [(4, 360, 320, 320, 2), (4, 360, 270, 320, 1), (3, 13, 270, 40, 16),
                                            (3, 13, 270, 40, 4), (1, 1, 1, 1, 1), (5, 70, 24, 344, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_conv_dw_ragged_and_f32(dev, B, T, cin, cout, d, dtype):
    """Channel counts off the 64-wide tiles and off 16, T shorter than d, one
    row; f32 on the CUDA cores."""
    g = torch.Generator(device=dev).manual_seed(B * T + d)
    x = torch.randn(B, T, cin, device=dev, generator=g).to(dtype)
    gy = torch.randn(B, T, cout, device=dev, generator=g).to(dtype)
    got = tap_conv_dw(x, gy, d)
    _close_scaled(got, tap_conv_dw_plain(x, gy, d), 1e-5 if dtype == torch.float32 else 1e-4)
    if d >= T:
        assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_conv_dw_is_deterministic(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 360, 320, device=dev, generator=g).to(dtype)
    gy = torch.randn(64, 360, 640, device=dev, generator=g).to(dtype)
    a = tap_conv_dw(x, gy, 2)
    b = tap_conv_dw(x, gy, 2)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_tap_conv_dw_rejects(dev):
    x = torch.zeros(2, 8, 16, device=dev)
    with pytest.raises(TypeError):
        tap_conv_dw(x, torch.zeros(2, 8, 4, device=dev).bfloat16(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        tap_conv_dw(x.transpose(0, 1).contiguous().transpose(0, 1), torch.zeros(2, 8, 4, device=dev), 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        tap_conv_dw(x, torch.zeros(2, 8, 4), 1)


# the bf16 bodies read x and g (K5: x and its packed weights) through TMA,
# which needs 16-byte row strides and bases: 270 channels and misaligned
# views reach the kernels as padded or realigned copies
@pytest.mark.parametrize("B,T,cin,cout,d", [(1, 360, 272, 270, 2), (2, 40, 270, 272, 4), (3, 13, 272, 272, 16),
                                            (1, 50, 270, 270, 16), (2, 200, 320, 640, 8)])
def test_tap_conv_dw_bf16_edges(dev, B, T, cin, cout, d):
    """270- and 272-channel x and g, T under one 64-row chunk, B=1, d >= T
    (the shifted taps are zero)."""
    g = torch.Generator(device=dev).manual_seed(B + T + cin + cout + d)
    x = torch.randn(B, T, cin, device=dev, generator=g).bfloat16()
    gy = torch.randn(B, T, cout, device=dev, generator=g).bfloat16()
    before = tap_conv_dw.launches
    got = tap_conv_dw(x, gy, d)
    assert tap_conv_dw.launches == before + 1 and got.shape == (3, cin, cout)
    _close_scaled(got, tap_conv_dw_plain(x, gy, d), 1e-4)
    if d >= T:
        assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("which", ["x", "g"])
def test_tap_conv_dw_bf16_misaligned_base(dev, which):
    """A contiguous view that starts 2 bytes into its allocation: copied to
    an aligned buffer, same answer as the plain version."""
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = {"x": (4, 90, 320), "g": (4, 90, 320)}
    t = {k: torch.randn(*v, device=dev, generator=g).bfloat16() for k, v in shapes.items()}
    flat = torch.zeros(t[which].numel() + 1, device=dev, dtype=torch.bfloat16)
    t[which] = flat[1:].view(shapes[which]).copy_(t[which])
    assert t[which].data_ptr() % 16
    _close_scaled(tap_conv_dw(t["x"], t["g"], 4), tap_conv_dw_plain(t["x"], t["g"], 4), 1e-4)


@pytest.mark.parametrize("B,D", [(333, 1004), (333, 1001), (512, 36864), (1, 8), (130, 3)])
def test_retrieval_ranks_kernel(dev, B, D):
    """Ranks equal the plain version's except on listed near-tie rows. D=1004
    ends in a half chunk; D=1001 is not a multiple of 4 (scalar loads)."""
    g = torch.Generator(device=dev).manual_seed(B + D)
    Y = torch.randn(B, D, device=dev, generator=g)
    # diagonal cosine about 2/sqrt(D), two standard deviations of a random
    # pair's: the diagonal beats most rows but not all, so ranks spread
    Z = 2 / D ** 0.5 * Y + torch.randn(B, D, device=dev, generator=g)
    before = retrieval_ranks.launches
    got = retrieval_ranks(Z.bfloat16(), Y)
    assert retrieval_ranks.launches == before + 1 and got.dtype == torch.int32
    want = retrieval_ranks_plain(Z.bfloat16(), Y)
    differ = set(torch.nonzero(got != want).flatten().tolist())
    assert differ <= near_tie_rows(Z.bfloat16(), Y), sorted(differ)[:10]
    if B > 100:
        assert len(torch.unique(want)) > 10  # ranks spread



def _k3_inputs(dev, B, D, ydtype, seed):
    """Z bf16 (the eval's embeddings), Y in ``ydtype``; Z = 2/sqrt(D)·Y +
    noise, so ranks spread."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Y = torch.randn(B, D, device=dev, generator=g)
    Z = 2 / D ** 0.5 * Y + torch.randn(B, D, device=dev, generator=g)
    return Z.bfloat16(), Y.to(ydtype)


def _k3_check(Z, Y, route, pieces=None):
    """One launch on ``route`` (with ``pieces``), two runs bitwise equal,
    ranks equal to the plain version's outside near ties; returns the
    plain ranks and the launch's depth slices."""
    before = retrieval_ranks.launches
    got = retrieval_ranks(Z, Y)
    assert retrieval_ranks.launches == before + 1 and got.dtype == torch.int32
    assert retrieval_ranks.route == route and retrieval_ranks.pieces == pieces
    splits = retrieval_ranks.splits
    again = retrieval_ranks(Z, Y)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = retrieval_ranks_plain(Z, Y)
    differ = set(torch.nonzero(got != want).flatten().tolist())
    assert differ <= near_tie_rows(Z, Y), sorted(differ)[:10]
    return want, splits


@pytest.mark.parametrize("ydtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D", [(64, 36864), (333, 1000), (2048, 4096), (130, 8)])
def test_retrieval_ranks_wgmma_route(dev, B, D, ydtype):
    """Z bf16 with Y f32 (three bf16 pieces) or bf16 (one): the wgmma body;
    ragged B (333, 130) and a depth under one 64-deep stage (8)."""
    Z, Y = _k3_inputs(dev, B, D, ydtype, B + D)
    want, _ = _k3_check(Z, Y, "wgmma", 3 if ydtype == torch.float32 else 1)
    if B > 100 and D > 8:
        assert len(torch.unique(want)) > 10  # ranks spread


@pytest.mark.parametrize("B", [64, 130])
def test_retrieval_ranks_split_depth(dev, B):
    """Fewer tiles than SMs: the depth is split across blocks (one 64 x 256
    tile at B=64, three at B=130) and the slices' partial tiles are added in
    a fixed order; at most one block a SM."""
    D = 36864
    Z, Y = _k3_inputs(dev, B, D, torch.float32, B)
    _, splits = _k3_check(Z, Y, "wgmma", 3)
    tiles = -(-B // 64) * -(-B // 256)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1 < splits and splits * tiles <= sms


@pytest.mark.parametrize("case", ["z_f32", "d1001", "z_misaligned", "y_misaligned"])
def test_retrieval_ranks_f32_route(dev, case):
    """Outside the wgmma body's domain the f32 CUDA-core body runs: f32 Z,
    D % 8 != 0, a base that is not 16-byte aligned."""
    B, D = 333, 1001 if case == "d1001" else 1000
    Z, Y = _k3_inputs(dev, B, D, torch.float32, 7)
    if case == "z_f32":
        Z = Z.float()
    elif case.endswith("misaligned"):
        t = Z if case == "z_misaligned" else Y
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        t = flat[1:].view(t.shape).copy_(t)
        Z, Y = (t, Y) if case == "z_misaligned" else (Z, t)
    _k3_check(Z, Y, "f32")

def test_train_step_card_matches_cpu(dev):
    """Three train steps at a small width in f32 on the card and on the CPU,
    the same weights, batches and masks: loss and temperature at rtol 1e-4,
    BN running variances at 1e-4 (sums in another order)."""
    import numpy as np

    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.training import create_train_state, make_train_step

    loc = np.random.default_rng(0).uniform(0.1, 0.9, (40, 2)).astype(np.float32)
    states = []
    for device in ("cpu", "cuda"):
        enc = BrainEncoder(num_subjects=3, loc=loc, D1=24, D2=32, F=16, K=4, channels_last_io=True,
                           generator=torch.Generator().manual_seed(1))
        states.append(create_train_state(enc, lr=1e-3, device=device))
    step = make_train_step()
    rng = np.random.default_rng(2)
    for i in range(3):
        batch = {"X": torch.from_numpy(rng.normal(size=(8, 50, 40)).astype(np.float32)),
                 "Y": torch.from_numpy(rng.normal(size=(8, 50, 16)).astype(np.float32)),
                 "subject_idxs": torch.from_numpy(rng.integers(0, 3, 8).astype(np.int32))}
        mask = (torch.arange(40) % 5 != i).float()
        out = []
        for st in states:
            dev_batch = {k: (v if k == "subject_idxs" else v.to(st.device)) for k, v in batch.items()}
            out.append(step(st, dev_batch, drop_mask=mask)[1])
        for k in ("loss", "temp"):
            torch.testing.assert_close(out[1][k].cpu(), out[0][k], rtol=1e-4, atol=1e-6)
    va = {k: v for k, v in states[0].encoder.named_buffers() if k.endswith("var")}
    for k, v in states[1].encoder.named_buffers():
        if k in va:
            torch.testing.assert_close(v.cpu(), va[k], rtol=1e-4, atol=1e-6)


# (Cin, Cout, d) of K5 at the flagship: forward convs and their dx forms
K5_SHAPES = [(270, 320, 1), (320, 320, 1), (320, 320, 16), (320, 640, 2), (640, 320, 2), (320, 270, 1)]


@pytest.mark.parametrize("cin,cout,d", K5_SHAPES)
def test_tap_conv_flagship_bf16(dev, cin, cout, d):
    """bf16 at B=64, T=360: both sides accumulate in f32 and cast once, so
    they differ by a flipped rounding (one bf16 ulp) at most."""
    g = torch.Generator(device=dev).manual_seed(cin + cout + d)
    x = torch.randn(64, 360, cin, device=dev, generator=g).bfloat16()
    w = torch.randn(3, cin, cout, device=dev, generator=g).div((3 * cin) ** 0.5).bfloat16()
    before = tap_conv.launches
    got = tap_conv(x, w, d)
    assert tap_conv.launches == before + 1 and got.dtype == torch.bfloat16
    _close_scaled(got, tap_conv_plain(x, w, d), 1e-2)


@pytest.mark.parametrize("B,T,cin,cout,d", [(4, 360, 320, 640, 2), (4, 360, 270, 320, 1), (3, 37, 270, 40, 16),
                                            (1, 2, 1, 1, 1), (5, 70, 24, 344, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_conv_ragged_and_f32(dev, B, T, cin, cout, d, dtype):
    g = torch.Generator(device=dev).manual_seed(B * T + d)
    x = torch.randn(B, T, cin, device=dev, generator=g).to(dtype)
    w = torch.randn(3, cin, cout, device=dev, generator=g).to(dtype)
    _close_scaled(tap_conv(x, w, d), tap_conv_plain(x, w, d), 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_conv_is_deterministic_and_its_vjp_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8, 360, 320, device=dev, generator=g).to(dtype)
    w = torch.randn(3, 320, 320, device=dev, generator=g).div(31).to(dtype)
    a, b = tap_conv(x, w, 4), tap_conv(x, w, 4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    gy = torch.randn(8, 360, 320, device=dev, generator=g).to(dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    PallasTapConv.apply(xa, wa, 4).backward(gy)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    _close_scaled(xa.grad, tap_conv_plain(gy, flip_taps(w), 4), rel)
    _close_scaled(wa.grad, tap_conv_dw_plain(x, gy, 4).to(dtype), rel)


def test_tap_conv_rejects(dev):
    x = torch.zeros(2, 8, 16, device=dev)
    with pytest.raises(TypeError):
        tap_conv(x, torch.zeros(3, 16, 4, device=dev).bfloat16(), 1)
    with pytest.raises(ValueError, match="dilation"):
        tap_conv(x, torch.zeros(3, 16, 4, device=dev), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tap_conv(x, torch.zeros(3, 4, 16, device=dev).transpose(1, 2), 1)


@pytest.mark.parametrize("B,T,cin,cout,d", [(1, 360, 272, 270, 2), (2, 40, 270, 272, 4), (1, 17, 272, 272, 16),
                                            (3, 100, 270, 270, 8), (2, 130, 640, 320, 1)])
def test_tap_conv_bf16_edges(dev, B, T, cin, cout, d):
    """270- and 272-channel x and outputs (the dx of block 0's conv0 writes
    270), T under one 128-row tile and just over it, B=1, d just under T."""
    g = torch.Generator(device=dev).manual_seed(B + T + cin + cout + d)
    x = torch.randn(B, T, cin, device=dev, generator=g).bfloat16()
    w = torch.randn(3, cin, cout, device=dev, generator=g).div((3 * cin) ** 0.5).bfloat16()
    before = tap_conv.launches
    got = tap_conv(x, w, d)
    assert tap_conv.launches == before + 1 and got.shape == (B, T, cout)
    _close_scaled(got, tap_conv_plain(x, w, d), 1e-2)


@pytest.mark.parametrize("which", ["x", "w"])
def test_tap_conv_bf16_misaligned_base(dev, which):
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = {"x": (3, 70, 320), "w": (3, 320, 160)}
    t = {k: torch.randn(*v, device=dev, generator=g).div(31 if k == "w" else 1).bfloat16() for k, v in shapes.items()}
    flat = torch.zeros(t[which].numel() + 1, device=dev, dtype=torch.bfloat16)
    t[which] = flat[1:].view(shapes[which]).copy_(t[which])
    assert t[which].data_ptr() % 16
    _close_scaled(tap_conv(t["x"], t["w"], 2), tap_conv_plain(t["x"], t["w"], 2), 1e-2)


@pytest.mark.parametrize("B,T,cin,cout,d", [(1, 360, 270, 320, 2), (2, 40, 272, 270, 4), (1, 17, 320, 640, 16),
                                            (3, 100, 270, 270, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_conv_transposed(dev, B, T, cin, cout, d, dtype):
    """K5's dx as PallasTapConv's backward launches it: g (B, T, Cout) with
    the forward's w (3, Cin, Cout), against the plain conv with
    flip_taps(w); 270-channel outputs (block 0's conv0) and inputs, B=1,
    T under one 128-row tile."""
    g = torch.Generator(device=dev).manual_seed(B + T + cin + cout + d)
    gy = torch.randn(B, T, cout, device=dev, generator=g).to(dtype)
    w = torch.randn(3, cin, cout, device=dev, generator=g).div((3 * cin) ** 0.5).to(dtype)
    before = tap_conv.launches
    got = tap_conv_transposed(gy, w, d)
    assert tap_conv.launches == before + 1 and got.shape == (B, T, cin)
    _close_scaled(got, tap_conv_plain(gy, flip_taps(w), d), 1e-5 if dtype == torch.float32 else 1e-2)


def test_tap_conv_transposed_misaligned_weights(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    gy = torch.randn(3, 70, 160, device=dev, generator=g).bfloat16()
    w = torch.randn(3, 320, 160, device=dev, generator=g).div(31).bfloat16()
    wm = torch.zeros(w.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(w.shape).copy_(w)
    assert wm.data_ptr() % 16
    _close_scaled(tap_conv_transposed(gy, wm, 2), tap_conv_plain(gy, flip_taps(w), 2), 1e-2)


def _k6_close(got, want, rel):
    """Activations in bf16: a flipped rounding (TOL); f32 results (sums, dW,
    db, f32 activations): ``rel`` of the largest entry."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            _close(a, b, torch.bfloat16)
        else:
            _close_scaled(a, b, rel)


@pytest.mark.parametrize("stage", list(cbt.STAGES))
@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("dtype,B,T", [(torch.bfloat16, 8, 360), (torch.float32, 2, 360), (torch.float32, 3, 37),
                                       (torch.bfloat16, 3, 37)])
def test_conv_block_train_stage(dev, stage, k, dtype, B, T):
    """Each K6 stage against its plain version: k=0 (Cin=270, no skip) and
    k=1..4 at C=320; T=37 puts d=16 past both edges of a tile. bf16 takes
    the wgmma route, f32 the tap3 route."""
    args = cbt.stage_inputs(B, T, 270 if k == 0 else 320, 320, k, dtype, dev,
                            torch.Generator(device=dev).manual_seed(10 * k + B))[stage]
    fn = cbt.STAGES[stage]
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    assert cbt.conv_block_train.route == ("wgmma" if dtype == torch.bfloat16 else "tap3")
    _k6_close(got, cbt.PLAIN[stage](*args), 1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize("stage", list(cbt.STAGES))
@pytest.mark.parametrize("k", [0, 2])
def test_conv_block_train_stage_on_tap3_in_bf16(dev, stage, k):
    """The tap3 body in bf16 (TILE: K7's bitwise partner and the wgmma
    route's yardstick) against the plain version."""
    args = cbt.stage_inputs(8, 360, 270 if k == 0 else 320, 320, k, torch.bfloat16, dev,
                            torch.Generator(device=dev).manual_seed(20 + k))[stage]
    fn = cbt.TILE[stage]
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1 and cbt.conv_block_train.route == "tap3"
    _k6_close(got, cbt.PLAIN[stage](*args), 1e-3)


def test_conv_block_train_misaligned_activation_takes_tap3(dev):
    """y1 whose base is not 16-byte aligned (the BN·GELU pass reads 16 bytes
    at a time): F3 takes the tap3 route and still matches."""
    gen = torch.Generator(device=dev).manual_seed(4)
    args = list(cbt.stage_inputs(3, 37, 320, 320, 1, torch.bfloat16, dev, gen)["F3"])
    y1 = args[0]
    args[0] = torch.zeros(y1.numel() + 1, device=dev, dtype=y1.dtype)[1:].view(y1.shape).copy_(y1)
    assert args[0].data_ptr() % 16
    got = cbt.f3(*args)
    assert cbt.conv_block_train.route == "tap3"
    _k6_close(got, cbt.f3_plain(*args), 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_block_train_stages_are_deterministic(dev, dtype):
    args = cbt.stage_inputs(8, 360, 320, 320, 2, dtype, dev, torch.Generator(device=dev).manual_seed(3))
    for stage, fn in cbt.STAGES.items():
        a, b = fn(*args[stage]), fn(*args[stage])
        assert cbt.conv_block_train.route == ("wgmma" if dtype == torch.bfloat16 else "tap3")
        torch.cuda.synchronize()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), stage


@pytest.mark.parametrize("stage", list(cbt.STAGES))
def test_conv_block_train_wgmma_stages_on_the_shared_body(dev, stage):
    """K6's stages on conv_wg (csrc/conv_wg.cuh, the body K4 shares) at the
    flagship's B=64: the wgmma route, within tolerance of the plain version,
    two runs bitwise equal."""
    args = cbt.stage_inputs(64, 360, 320, 320, 1, torch.bfloat16, dev, torch.Generator(device=dev).manual_seed(5))
    fn = cbt.STAGES[stage]
    a = fn(*args[stage])
    assert cbt.conv_block_train.route == "wgmma"
    b = fn(*args[stage])
    torch.cuda.synchronize()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)
    _k6_close(a, cbt.PLAIN[stage](*args[stage]), 1e-3)


@pytest.mark.parametrize("k", [0, 3])
def test_conv_block_train_matches_module_block(dev, k):
    """f32: out, the batch statistics and all 11 gradients of one block
    against the module ConvBlock's train forward with autograd (the same
    function; sums in another order: 1e-4 of each tensor's largest entry
    plus 1e-5 of the largest gradient, since the conv biases ahead of a
    batch-stat BN have a zero gradient in exact arithmetic and hold rounding
    noise on both sides)."""
    from speech_decoding_tpu_torch.models.brain_encoder import ConvBlock

    cin = 270 if k == 0 else 320
    blk = ConvBlock(k, cin, 320, generator=torch.Generator().manual_seed(k)).to(dev)
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn(4, 360, cin, device=dev, generator=g, requires_grad=True)
    gy = torch.randn(4, 360, 320, device=dev, generator=g)
    params = [p.detach().clone().requires_grad_() for p in blk.parameters()]
    blk(x, train=True).backward(gy)
    want = [x.grad] + [p.grad for p in blk.parameters()]
    x2 = x.detach().clone().requires_grad_()
    out, _ = cbt.conv_block_train(x2, *params, k)
    out.backward(gy)
    torch.cuda.synchronize()
    gmax = max(float(b.abs().max()) for b in want)
    for a, b in zip([x2.grad] + [p.grad for p in params], want):
        assert bool(((a - b).abs() <= 1e-4 * float(b.abs().max()) + 1e-5 * gmax).all())


def _f31_inputs(B, T, k_next, dtype, dev, seed):
    """F3's arguments of block k_next - 1 and F1's weights of block k_next."""
    ins = cbt.stage_inputs(B, T, 320, 320, k_next, dtype, dev, torch.Generator(device=dev).manual_seed(seed))
    return (*ins["F3"], *ins["F1"][1:3], k_next)


def _pair(args, f3, f1):
    out = f3(*args[:5])
    return (out, *f1(out, args[5], args[6], args[7]))


@pytest.mark.parametrize("k_next", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,B,T", [(torch.bfloat16, 8, 360), (torch.float32, 2, 360), (torch.float32, 3, 37),
                                       (torch.bfloat16, 3, 37)])
def test_f31_kernel(dev, k_next, dtype, B, T):
    """K7 against its plain version (out and y0n as activations, s0n at 1e-4
    (f32) or 1e-3 (bf16) of its largest entry) and against the K6 pair of
    its route on the same inputs: bf16 takes the wgmma route, bitwise the
    wgmma pair f3 then f1 (out, y0n and s0n); f32 the tap3 route, bitwise
    the tap3 pair f3_tile then f1_tile in out and y0n, s0n within rtol 1e-6.
    T=37 with d0n=16 (k_next=2) puts the reads past both edges of the
    recording."""
    args = _f31_inputs(B, T, k_next, dtype, dev, 7 * k_next + B)
    before = cbt.f31.launches
    out, y0n, s0n = cbt.f31(*args)
    assert cbt.f31.launches == before + 1
    route = cbt.f31.route
    assert route == ("wgmma" if dtype == torch.bfloat16 else "tap3")
    rel = 1e-4 if dtype == torch.float32 else 1e-3
    _k6_close((out, y0n, s0n), cbt.f31_plain(*args), rel)
    o_p, y_p, s_p = _pair(args, cbt.f3, cbt.f1) if route == "wgmma" else _pair(args, cbt.f3_tile, cbt.f1_tile)
    torch.cuda.synchronize()
    assert torch.equal(out, o_p) and torch.equal(y0n, y_p)
    torch.testing.assert_close(s0n, s_p, rtol=0.0 if route == "wgmma" else 1e-6, atol=0.0)


@pytest.mark.parametrize("B,T,k_next", [(64, 360, 1), (64, 360, 2), (64, 360, 3), (64, 360, 4), (3, 37, 2),
                                        (3, 400, 2), (3, 400, 3)])
def test_f31_wgmma_is_the_wgmma_pair_bitwise(dev, B, T, k_next):
    """The merged walk at the flagship for every boundary, at T=37 (one time
    tile, d0n=16 past both edges) and at T=400 (three time tiles: the middle
    one's F1 reads both neighbours' F3 tiles): the wgmma route, out, y0n and
    s0n bitwise f3 then f1, and each half within tolerance of its plain
    stage: out of f3_plain, y0n and s0n of f1_plain on K7's own out (on
    f3_plain's out, each flipped bf16 rounding of out would reach y0n
    through the skip, where y0n can cancel to near zero)."""
    args = _f31_inputs(B, T, k_next, torch.bfloat16, dev, 11 * k_next + T)
    got = cbt.f31(*args)
    assert cbt.f31.route == "wgmma"
    want = _pair(args, cbt.f3, cbt.f1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _k6_close(got[0], cbt.f3_plain(*args[:5]), 1e-3)
    _k6_close(got[1:], cbt.f1_plain(got[0], args[5], args[6], k_next), 1e-3)


def test_f31_wgmma_repeats_on_the_same_scratch(dev):
    """Two calls give the same bits although the second call's scratch is
    the first's memory filled with garbage: the claim and ready counters are
    zeroed for every launch. After each, the claim counter holds every tile
    plus one claim past the end by each block."""
    B, T, C = 64, 360, 320
    args = _f31_inputs(B, T, 2, torch.bfloat16, dev, 2)
    a = cbt.f31(*args)
    first = cbt.f31_wait_stats()
    n = cbt._f31_scratch_elems(B, T, C)
    cbt.f31.sync = None
    torch.full((n,), -7.0, device=dev)  # freed at once: the next scratch of this size is likely this memory
    b = cbt.f31(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    tiles = len(cbt._f31_order(B, T, C))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert first["claims"] == cbt.f31_wait_stats()["claims"] == tiles + min(tiles, sms)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,k_next", [(360, 1), (37, 2)])
def test_f31_tile_is_the_tap3_pair(dev, dtype, T, k_next):
    """f31_tile runs the tap3 route in any dtype: bitwise the tap3 pair in
    out and y0n, s0n within rtol 1e-6, and within tolerance of plain."""
    args = _f31_inputs(3, T, k_next, dtype, dev, 5 + k_next)
    before = cbt.f31_tile.launches
    got = cbt.f31_tile(*args)
    assert cbt.f31_tile.launches == before + 1 and cbt.f31.route == "tap3"
    o_s, y_s, s_s = _pair(args, cbt.f3_tile, cbt.f1_tile)
    torch.cuda.synchronize()
    assert torch.equal(got[0], o_s) and torch.equal(got[1], y_s)
    torch.testing.assert_close(got[2], s_s, rtol=1e-6, atol=0.0)
    _k6_close(got, cbt.f31_plain(*args), 1e-4 if dtype == torch.float32 else 1e-3)


def test_f31_outside_the_rule_takes_tap3(dev):
    """bf16 with C = 20 (not a multiple of 8) or a y1 whose base is not
    16-byte aligned takes the tap3 route and still matches the tap3 pair."""
    g = torch.Generator(device=dev).manual_seed(9)
    ins = cbt.stage_inputs(3, 37, 20, 20, 1, torch.bfloat16, dev, g)
    odd = (*ins["F3"], *ins["F1"][1:3], 1)
    args = list(_f31_inputs(3, 37, 1, torch.bfloat16, dev, 9))
    y1 = args[0]
    args[0] = torch.zeros(y1.numel() + 1, device=dev, dtype=y1.dtype)[1:].view(y1.shape).copy_(y1)
    assert args[0].data_ptr() % 16
    for a in (odd, tuple(args)):
        got = cbt.f31(*a)
        assert cbt.f31.route == "tap3"
        o_s, y_s, s_s = _pair(a, cbt.f3_tile, cbt.f1_tile)
        torch.cuda.synchronize()
        assert torch.equal(got[0], o_s) and torch.equal(got[1], y_s)
        _k6_close(got, cbt.f31_plain(*a), 1e-3)


def test_f31_is_deterministic_and_rejects(dev):
    args = _f31_inputs(8, 360, 2, torch.bfloat16, dev, 1)
    a, b = cbt.f31(*args), cbt.f31(*args)
    assert cbt.f31.route == "wgmma"
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="k_next"):
        cbt.f31(*args[:-1], 0)
    with pytest.raises(ValueError, match="argument 6"):
        cbt.f31(*args[:5], args[5][:, :8].contiguous(), args[6], 2)


# -- the data layer and the CLI on the card ------------------------------------------------


def _tiny_gwilliams(dev, root, **over):
    """A tiny Gwilliams tree, its caches built on the card (the port's tiny
    wav2vec2 there), and the CLI's config for it (tests/test_cli.py's
    widths, f32)."""
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022ShallowSplit
    from speech_decoding_tpu_torch.data.synthetic import make_config, make_gwilliams_tree, tiny_wav2vec

    make_gwilliams_tree(root)
    dims = dict(num_subjects=2, num_sessions=2, num_tasks=2)
    cfg = make_config(root, "Gwilliams2022", epochs=2, batch_size=4, updates=3, D1=16, D2=16, K=4, F=16, **{
        "preprocs.last4layers": False, "tpu.compute_dtype": "float32", "checkpoint.dir": "checkpoints",
        **{f"gwilliams.{k}": v for k, v in dims.items()}, **over})
    build = cfg.copy()
    build.rebuild_dataset = True
    ds = Gwilliams2022ShallowSplit(build, wav2vec=tiny_wav2vec(device=dev), device=dev, **dims)
    return cfg, ds


@pytest.mark.parametrize("store", ["float32", "int16"])
@pytest.mark.parametrize("channels_last", [False, True])
def test_device_resident_gather_on_the_card(dev, tmp_path, store, channels_last):
    """The gather on the card against the host sample_batch (native gather)
    under the same rng: f32 stacks bit for bit (transposed for
    channels-last), int16 within half a quantization step of each
    (recording, channel) (f32 rounding aside)."""
    import numpy as np

    from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams

    _, ds = _tiny_gwilliams(dev, str(tmp_path))
    b = DeviceResidentGwilliams(ds, store_dtype=store, channels_last=channels_last, device=dev)
    assert b.X_stack.is_cuda and b.X_stack.dtype == getattr(torch, store)
    ids = np.array([3, 40, 0, 17, 29, 8])
    idx = b.make_index_batch(np.random.default_rng(5), ids)
    got = b.gather(idx)
    want = ds.sample_batch(np.random.default_rng(5), ids)
    assert got["X"].is_cuda and not got["subject_idxs"].is_cuda
    for k in ("X", "Y"):
        g = got[k].cpu().numpy()
        g = g.transpose(0, 2, 1) if channels_last else g
        if store == "float32":
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:  # round-half-up: half a step of the (recording or task, channel) scale
            step = (b.x_scale[idx["rec_idx"]] if k == "X" else b.y_scale[idx["task_idx"]]).cpu().numpy()[..., None]
            assert (np.abs(g - want[k]) <= 0.5 * step * (1 + 1e-3) + 1e-6 * np.abs(want[k])).all(), k
    np.testing.assert_array_equal(got["scale_stats"].cpu().numpy(), want["scale_stats"])
    np.testing.assert_array_equal(got["subject_idxs"].numpy(), want["subject_idxs"])


def test_tiny_cli_run_on_the_card(dev, tmp_path):
    """``train.run`` on the card with device-resident data (scan pairs):
    finite losses, launches per step K1 2 and K2 15, K3 1 an eval; then
    ``evaluate`` reproduces the last epoch's eval from host batches."""
    import numpy as np

    from speech_decoding_tpu_torch import train
    from speech_decoding_tpu_torch.tools.evaluate import evaluate

    cfg, _ = _tiny_gwilliams(dev, str(tmp_path), **{"tpu.device_resident_data": True, "tpu.scan_steps": 2})
    counted = (subject_matmul, tap_conv_dw, retrieval_ranks, tcb.conv_block_fused, tap_conv)
    before = [fn.launches for fn in counted]
    hist = train.run(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = [fn.launches - b for fn, b in zip(counted, before)]
    steps, evals = cfg.epochs * cfg.updates, cfg.epochs
    assert launches == [2 * steps + evals, 15 * steps, evals, 0, 0]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["test_loss"]) for h in hist)
    out = evaluate(cfg.copy(), device="cuda")
    assert out["epoch"] == hist[-1]["epoch"]
    assert out["test_loss"] == pytest.approx(hist[-1]["test_loss"], rel=2e-4)
    assert out["testTop10acc"] == pytest.approx(hist[-1]["testTop10acc"], abs=1e-6)
