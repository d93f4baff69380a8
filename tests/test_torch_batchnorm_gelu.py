"""The train-mode BatchNorm + GELU op (``ops.batchnorm_gelu``) on the CPU:
its plain version, which the op runs for CPU tensors, and ``TorchBatchNorm``'s
train forward then GELU give the bits of the BatchNorm formulas as written
before the op (output, running statistics, the gradients of y, the skip,
scale and bias; a remat recomputation leaves the statistics alone);
``ConvBlock`` on every path that keeps today's ops (the CPU, a data-parallel
group, eval mode, f32) gives the bits of the formulas before the op; and
``BN_roofline.train``'s arithmetic. The kernels themselves run on the
card: ``test_torch_batchnorm_gelu_cuda.py``.
"""

import copy
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from port_bench import cells  # noqa: E402
from speech_decoding_tpu_torch.models import brain_encoder as be  # noqa: E402
from speech_decoding_tpu_torch.ops import batchnorm_gelu as bg  # noqa: E402

B, T, C = 3, 11, 16


def _inputs(dtype, skip: bool, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = (2 * torch.randn(B, T, C, generator=g) + 0.5).to(dtype)
    s = torch.randn(B, T, C, generator=g).to(dtype) if skip else None
    scale, bias = 0.5 + torch.rand(C, generator=g), 0.1 * torch.randn(C, generator=g)
    mean, var = 0.1 * torch.randn(C, generator=g), 0.5 + torch.rand(C, generator=g)
    dh = torch.randn(B, T, C, generator=g).to(dtype)
    return y, s, scale, bias, mean, var, dh


def _grads(h, leaves, dh):
    return torch.autograd.grad(h, [t for t in leaves if t is not None], dh)


def _bn_before(bn, x, train, group=None, replaying=False):
    """``TorchBatchNorm.forward`` as it was written before the op, without
    remat's kept sums: f32 statistics, the running ones moved unless
    ``replaying``, the normalisation in the compute dtype."""
    if train:
        xf = x.float()
        n = x.shape[0] * x.shape[1]
        if group is None:
            mean = xf.mean(dim=(0, 1))
            var = (xf * xf).mean(dim=(0, 1)) - mean * mean
        else:
            n *= group.world
            sums = be.all_reduce_sum(torch.stack([xf.sum(dim=(0, 1)), (xf * xf).sum(dim=(0, 1))]), group)
            mean = sums[0] / n
            var = sums[1] / n - mean * mean
        if not replaying:
            with torch.no_grad():
                m = bn.momentum
                bn.mean.mul_(1 - m).add_(m * mean)
                bn.var.mul_(1 - m).add_(m * (var * (n / max(n - 1, 1))))
    else:
        mean, var = bn.mean, bn.var
    inv = torch.rsqrt(var + bn.eps) * bn.scale
    dt = bn.compute_dtype
    return (x.to(dt) - mean.to(dt)) * inv.to(dt) + bn.bias.to(dt)


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_torch_batchnorm_then_gelu(dtype, skip, update):
    """``bn_gelu_train`` on CPU tensors, and ``TorchBatchNorm`` (compute
    dtype = y's) in train mode then ``_gelu``, which share the statistics
    and normalisation functions, against the BatchNorm formulas as written
    before them, the skip added before, bit for bit: output, running
    statistics, the gradients of y, the skip, scale and bias. With
    ``update`` False, as inside a remat recomputation, all leave the
    running statistics as they were."""
    y, s, scale, bias, mean, var, dh = _inputs(dtype, skip)
    bns = []
    for _ in range(2):
        bn = be.TorchBatchNorm(C, compute_dtype=dtype)
        with torch.no_grad():
            bn.scale.copy_(scale)
            bn.bias.copy_(bias)
            bn.mean.copy_(mean)
            bn.var.copy_(var)
        bns.append(bn)
    ya, sa = y.clone().requires_grad_(), None if s is None else s.clone().requires_grad_()
    want = be._gelu(_bn_before(bns[0], ya if sa is None else ya + sa, True, replaying=not update))
    want_grads = _grads(want, [ya, sa, bns[0].scale, bns[0].bias], dh)

    yb, sb = y.clone().requires_grad_(), None if s is None else s.clone().requires_grad_()
    sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    m, v = mean.clone(), var.clone()
    got = bg.bn_gelu_train(yb, sb, sc, bi, m, v, bns[0].eps, bns[0].momentum, update=update)
    got_grads = _grads(got, [yb, sb, sc, bi], dh)

    yc, sc_ = y.clone().requires_grad_(), None if s is None else s.clone().requires_grad_()
    stash = be._RematStash()
    with stash._active(replaying=not update):
        mod = be._gelu(bns[1](yc if sc_ is None else yc + sc_, train=True))
    mod_grads = _grads(mod, [yc, sc_, bns[1].scale, bns[1].bias], dh)

    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(mod, want)
    assert torch.equal(m, bns[0].mean) and torch.equal(v, bns[0].var)
    assert torch.equal(bns[1].mean, bns[0].mean) and torch.equal(bns[1].var, bns[0].var)
    if not update:
        assert torch.equal(m, mean) and torch.equal(v, var)
    assert len(got_grads) == len(want_grads) == len(mod_grads)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    assert all(torch.equal(a, b) for a, b in zip(mod_grads, want_grads))


def _before(blk, X, train, group):
    """``ConvBlock.forward`` as it was before the op: the skip adds,
    ``TorchBatchNorm`` as it was written then, and GELU, as separate ops."""
    Y = blk.conv0(X)
    if blk.k > 0:
        Y = Y + X
    Y = be._gelu(_bn_before(blk.batchnorm0, Y, train, group))
    Y = blk.conv1(Y) + Y
    Y = be._gelu(_bn_before(blk.batchnorm1, Y, train, group))
    a, b = blk.conv2(Y).chunk(2, dim=-1)
    return a * torch.sigmoid(b)


# (compute dtype, train, with a data-parallel group stand-in)
PATHS = [(torch.bfloat16, True, False), (torch.float32, True, False), (torch.bfloat16, False, False),
         (torch.float32, False, False), (torch.bfloat16, True, True), (torch.float32, True, True)]


@pytest.mark.parametrize("dtype,train,grouped", PATHS)
@pytest.mark.parametrize("k", [0, 1])
def test_conv_block_keeps_todays_bits_off_the_card(monkeypatch, k, dtype, train, grouped):
    """``ConvBlock`` on the CPU (train and eval, bf16 and f32, with and
    without a group stand-in of world 1 whose all-reduce is the identity)
    against the pre-op formulas on a copy of the block: output, the input's
    and every parameter's gradient and the running statistics, bit for
    bit."""
    monkeypatch.setattr(be, "all_reduce_sum", lambda t, group: t)
    group = be.DataGroup(world=1, rank=0, device=torch.device("cpu")) if grouped else None
    D = 16
    blk = be.ConvBlock(k, D, D, dtype, torch.Generator().manual_seed(k))
    ref = copy.deepcopy(blk)
    X = torch.randn(2, 13, D, generator=torch.Generator().manual_seed(7)).to(dtype)
    xa, xb = X.clone().requires_grad_(), X.clone().requires_grad_()
    out = blk(xa, train, group)
    want = _before(ref, xb, train, group)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(8)).to(dtype)
    out.backward(g)
    want.backward(g)
    assert torch.equal(out, want) and torch.equal(xa.grad, xb.grad)
    for (name, p), q in zip(blk.named_parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, b), c in zip(blk.named_buffers(), ref.buffers()):
        assert torch.equal(b, c), name


def test_the_module_routes_no_cpu_tensor_to_the_kernels():
    """The kernels' rule takes bf16 (B, T, C) CUDA tensors alone."""
    assert not bg.takes(torch.zeros(2, 3, 16, dtype=torch.bfloat16))
    assert not bg.takes(torch.zeros(2, 3, 16, dtype=torch.bfloat16, device="meta"))


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_seconds(self, match):
        return sum(s for name, s in self.kernels if match(name))


@pytest.mark.parametrize("kernels,want", [
    # 0.88 ms of compulsory bytes a step at B=256 (5·B·T·D2·2 bytes over ten layers at 3.35 TB/s)
    ([("bngelu_stats_kernel(...)", 0.5), ("bngelu_bwd_dy_kernel(...)", 1.26), ("bn_gelu_kernel", 9.0),
      ("tap_conv_dw_bf16_kernel", 3.0)], 100.0 * 1000 * 10 * 5 * 256 * 360 * 320 * 2 / 3.35e12 / 1.76),
    ([("bn_gelu_kernel", 9.0), ("tap_conv_dw_bf16_kernel", 3.0)], None),
])
def test_bn_roofline_reads_the_new_kernels_alone(kernels, want):
    """``BN_roofline.train``: the window's steps times the ten layers'
    compulsory bytes over the device time of the ``bngelu_`` kernels (not
    K6's ``bn_gelu_kernel``); nothing to read, no metric."""
    read = cells.metric_reader("BN_roofline.train")
    cell = cells.Cell("gw208-train-b256-resident")
    ctx = SimpleNamespace(trace=_Trace(kernels), counts={"steps": 1000, "batch": 256}, cfg=cell.config)
    got = read(ctx)
    assert got == pytest.approx(want) if want is not None else got is None
    assert read(SimpleNamespace(trace=None, counts={"steps": 1000, "batch": 256}, cfg=cell.config)) is None
