"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips when no CUDA device is present (the
CPU tier holds the plain versions against JAX instead). Run on a GPU with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.ops import conv_block as tcb  # noqa: E402
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul, subject_matmul_plain  # noqa: E402

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
        tcb.stage_weight(r(3, d2, 2 * d2) / (3 * d2) ** 0.5, dtype), 0.1 * r(2 * d2),
    )


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D1,D2", [(2, 360, 270, 320), (3, 37, 40, 48), (2, 5, 16, 16)])
def test_conv_block_kernel(dev, k, dtype, B, T, D1, D2):
    cin = D1 if k == 0 else D2
    args = _staged(dev, cin, D2, dtype, seed=k)
    x = torch.randn(B, T, cin, device=dev).to(dtype)
    before = tcb.conv_block_fused.launches
    got = tcb.conv_block_fused(x, *args, k=k)
    assert tcb.conv_block_fused.launches == before + 1
    _close(got, tcb.conv_block_plain(x, *args, k=k), dtype, scale=1.0 if dtype == torch.bfloat16 else 10.0)


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
    odd = [a.bfloat16() if a.dtype == torch.float32 and a.dim() == 3 else a
           for a in _staged(dev, 24, 24, torch.float32, seed=0)]
    with pytest.raises(ValueError, match="D2 % 16"):
        tcb.conv_block_fused(torch.zeros(2, 8, 24, device=dev, dtype=torch.bfloat16), *odd, k=0)
    # bf16 weights must come staged: conv0's depth padded to 16, 16-byte aligned
    raw = [a.bfloat16() if a.dim() == 3 else a for a in _staged(dev, 24, 16, torch.float32, seed=0)]
    x16 = torch.zeros(2, 8, 24, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="argument 1"):
        tcb.conv_block_fused(x16, *raw, k=0)
    staged = list(_staged(dev, 24, 16, torch.bfloat16, seed=0))
    w0 = staged[0]
    staged[0] = torch.zeros(w0.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(w0.shape).copy_(w0)
    with pytest.raises(ValueError, match="aligned"):
        tcb.conv_block_fused(x16, *staged, k=0)


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
