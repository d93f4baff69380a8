"""The train-mode BatchNorm + GELU kernels (``ops.batchnorm_gelu``,
``csrc/batchnorm_gelu.cu``) on the card: at the benchmark cell's shape
(256 × 360 × 320) and a ragged one (3 × 17 × 320), with and without the
residual input, against the plain version; a CUDA-graph replay of forward
and backward bitwise the eager call; one layer's kernel records; and the
module's route. Marked ``cuda``; each test skips without a CUDA device
(the CPU tier holds the plain version against ``TorchBatchNorm``:
``test_torch_batchnorm_gelu.py``). Run on a GPU with

    python -m pytest tests/test_torch_batchnorm_gelu_cuda.py -m cuda -q --noconftest
"""

import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.models import brain_encoder as be  # noqa: E402
from speech_decoding_tpu_torch.ops import batchnorm_gelu as bg  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(256, 360, 320), (3, 17, 320)]
EPS, MOMENTUM = 1e-5, 0.1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, shape, skip: bool, seed=0):
    """bf16 activations with a non-zero mean, a skip of the same shape (or
    None), f32 BN parameters and running statistics, a bf16 cotangent."""
    C = shape[-1]
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (2 * torch.randn(*shape, device=dev, generator=g) + 0.5).bfloat16()
    s = torch.randn(*shape, device=dev, generator=g).bfloat16() if skip else None
    scale = 0.5 + torch.rand(C, device=dev, generator=g)
    bias = 0.1 * torch.randn(C, device=dev, generator=g)
    mean = 0.1 * torch.randn(C, device=dev, generator=g)
    var = 0.5 + torch.rand(C, device=dev, generator=g)
    dh = torch.randn(*shape, device=dev, generator=g).bfloat16()
    return a, s, scale, bias, mean, var, dh


def _leaves(a, s, scale, bias):
    return [t.detach().clone().requires_grad_() for t in (a, s, scale, bias) if t is not None]


def _op(leaves, mean, var, dh, fn=bg.bn_gelu_train):
    """h and the gradients of ``leaves`` (a, the skip if any, scale, bias)
    of one forward and backward, moving ``mean`` and ``var`` in place."""
    skip = leaves[1] if len(leaves) == 4 else None
    h = fn(leaves[0], skip, leaves[-2], leaves[-1], mean, var, EPS, MOMENTUM)
    return h.detach(), torch.autograd.grad(h, leaves, dh)


def _call(a, s, scale, bias, mean, var, dh, fn=bg.bn_gelu_train):
    return _op(_leaves(a, s, scale, bias), mean, var, dh, fn)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_running_statistics_match_the_plain_version(dev, shape, skip):
    """h against the plain version in bf16 on the same inputs. Both compute
    the statistics in f32 and normalise with the same three bf16 roundings;
    the sums run in another order, so a rounded constant (mean, inv) may
    differ by one bf16 ulp (2^-8 relative), and the kernel's erf (within
    1.5e-7 of torch.erf) may flip GELU's rounding: an output moves by a few
    ulps at most, |Δh| ≤ 2^-6·|h| + 2^-8. The running statistics move by
    the same f32 formulas from sums in another order: rtol 1e-5."""
    a, s, scale, bias, mean, var, dh = _inputs(dev, shape, skip)
    m0, v0 = mean.clone(), var.clone()
    h = bg.bn_gelu_train(a, s, scale, bias, mean, var, EPS, MOMENTUM)
    mp, vp = m0.clone(), v0.clone()
    hp = bg.bn_gelu_train_plain(a, s, scale, bias, mp, vp, EPS, MOMENTUM)
    assert h.dtype == torch.bfloat16 and h.shape == a.shape
    torch.testing.assert_close(h.float(), hp.float(), rtol=2.0 ** -6, atol=2.0 ** -8)
    torch.testing.assert_close(mean, mp, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(var, vp, rtol=1e-5, atol=1e-7)
    # a remat recomputation leaves them alone
    m1, v1 = mean.clone(), var.clone()
    h2 = bg.bn_gelu_train(a, s, scale, bias, mean, var, EPS, MOMENTUM, update=False)
    assert torch.equal(mean, m1) and torch.equal(var, v1) and torch.equal(h2, h)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_the_f32_plain_version(dev, shape, skip):
    """dy (the skip's gradient is the same tensor), dscale and dbias against
    the plain version in f32 (autograd) on y = bf16(a + skip), the kernel's
    y. The kernels compute in f32 too and round dy to bf16 once: |Δdy| ≤
    2^-8·|dy| (one rounding to nearest, at most bf16's unit roundoff 2^-8,
    which a value just above a power of two nearly reaches) +
    2^-14·inv0·scale·(|dh| + 1 + |x̂|) (f32 errors, ~1e-6 of each term of
    the cancelling bracket, and GELU''s 1.5e-7, with ~60x room). dscale and
    dbias are f32 sums over B·T rows in another order: within 2^-16 of the
    sum of their terms' bounds, Σ|dh|·(1 + |x̂|) (f32 summation errors ~1e-6
    of it)."""
    a, s, scale, bias, mean, var, dh = _inputs(dev, shape, skip, seed=1)
    h, grads = _call(a, s, scale, bias, mean.clone(), var.clone(), dh)
    dy, dscale, dbias = grads[0], grads[-2], grads[-1]
    if skip:
        assert torch.equal(grads[1], dy)
    y = (a if s is None else a + s).float()
    _, ref = _call(y, None, scale, bias, mean.clone(), var.clone(), dh.float(), fn=bg.bn_gelu_train_plain)
    dy_ref, dscale_ref, dbias_ref = ref

    m = y.mean(dim=(0, 1))
    inv0 = torch.rsqrt((y * y).mean(dim=(0, 1)) - m * m + EPS)
    xhat = (y - m) * inv0
    dhf = dh.float().abs()
    assert dy.dtype == torch.bfloat16
    err = (dy.float() - dy_ref).abs()
    tol = 2.0 ** -8 * dy_ref.abs() + 2.0 ** -14 * inv0 * scale * (dhf + 1 + xhat.abs())
    assert (err <= tol).all(), (err / tol).max()
    bound = (dhf * (1 + xhat.abs())).sum(dim=(0, 1))
    for got, want in ((dbias, dbias_ref), (dscale, dscale_ref)):
        assert ((got - want).abs() <= 2.0 ** -16 * bound).all(), ((got - want).abs() / bound).max()


@pytest.mark.parametrize("skip", [False, True])
def test_graph_replay_is_bitwise_the_eager_call(dev, skip):
    """Forward and backward captured in a CUDA graph, replayed from the same
    running statistics, give the eager call's bits: h, every gradient and
    the moved statistics."""
    a, s, scale, bias, mean, var, dh = _inputs(dev, SHAPES[0], skip, seed=2)
    m0, v0 = mean.clone(), var.clone()
    h_e, g_e = _call(a, s, scale, bias, mean, var, dh)
    m_e, v_e = mean.clone(), var.clone()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            _call(a, s, scale, bias, mean, var, dh)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_g, g_g = _call(a, s, scale, bias, mean, var, dh)
    mean.copy_(m0)
    var.copy_(v0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(h_g, h_e)
    assert all(torch.equal(x, y) for x, y in zip(g_g, g_e))
    assert torch.equal(mean, m_e) and torch.equal(var, v_e)


def test_a_layer_records_only_the_new_kernels(dev):
    """One layer's forward and backward (with the skip), from the
    profiler's kernel records: the six kernels of the op and no ATen
    elementwise, reduction or copy kernel, as many as the launch counter
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, s, scale, bias, mean, var, dh = _inputs(dev, SHAPES[0], True, seed=3)
    leaves = _leaves(a, s, scale, bias)
    _op(leaves, mean, var, dh)  # load the library
    torch.cuda.synchronize()
    before = bg.bn_gelu_train.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _op(leaves, mean, var, dh)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert len(names) == 6 and all("bngelu_" in n for n in names), names
    assert bg.bn_gelu_train.launches - before == len(names)


def test_the_module_routes_single_card_bf16_train_mode_only(dev):
    """``ConvBlock`` on the card: train mode in bf16 with no group runs both
    BatchNorms through the op (a forward each, three kernels); eval mode,
    f32 and a data-parallel group stand-in (world 1, its all-reduce the
    identity) run today's ops."""
    x = torch.randn(2, 24, 32, device=dev)
    before = bg.bn_gelu_train.launches

    def run(dtype, train, group=None):
        blk = be.ConvBlock(1, 32, 32, dtype, torch.Generator().manual_seed(0)).to(dev)
        blk(x.to(dtype), train, group)
        return bg.bn_gelu_train.launches - before

    assert run(torch.bfloat16, True) == 2 * bg.KERNELS
    before = bg.bn_gelu_train.launches
    assert run(torch.bfloat16, False) == 0 and run(torch.float32, True) == 0
    mp = pytest.MonkeyPatch()
    mp.setattr(be, "all_reduce_sum", lambda t, group: t)
    try:
        stand_in = be.DataGroup(world=1, rank=0, device=dev)
        assert run(torch.bfloat16, True, stand_in) == 0
    finally:
        mp.undo()
