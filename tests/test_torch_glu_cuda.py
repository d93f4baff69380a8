"""The GLU kernels (``ops.glu``, ``csrc/glu.cu``) on the card: forward and
backward against the f32 formulas within one bf16 rounding, at the
benchmark cell's shape (256 × 360 × 640) and at a ragged row count; a
CUDA-graph replay bitwise the eager call; one block's kernel records and
``glu.launches``; and the module's route. Marked ``cuda``; each test skips
without a CUDA device (the CPU tier holds the plain route against the
reference's formula: ``test_torch_glu.py``). Run on a GPU with

    python -m pytest tests/test_torch_glu_cuda.py -m cuda -q --noconftest
"""

import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.models import brain_encoder as be  # noqa: E402
from speech_decoding_tpu_torch.ops import glu as gl  # noqa: E402
from speech_decoding_tpu_torch.tools import bench_glu  # noqa: E402

pytestmark = pytest.mark.cuda

# the flagship; a ragged row count (B·T = 51, not a multiple of a block's
# threads) at the flagship's width; the narrowest D
SHAPES = [(256, 360, 640), (3, 17, 640), (5, 7, 16)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_backward_within_one_rounding_of_f32(dev, shape):
    """h and dY against the f32 formulas on the same bf16 Y and g: the
    kernels compute σ and the products in f32 and round each output once,
    so |Δ| ≤ 2^-8·|want| (bf16's unit roundoff) with 2^-16 of it for f32's
    own errors, and for db = g·a·σ·(1 − σ) 2^-23·|g·a| more, two f32 ulps
    of σ where 1 − σ cancels (``tools.bench_glu.check``, which raises past
    it). The plain chain is not held to this: it rounds σ(b) to bf16
    first."""
    out = bench_glu.check(shape, dev)
    assert out["h_over_one_rounding"] <= 1.0 and out["dy_over_one_rounding"] <= 1.0, out


def test_dy_fills_both_halves_and_h_has_half_the_width(dev):
    """h has half Y's width; a zero cotangent gives a zero dY (both halves
    written: nothing of a previous buffer leaks through); with a = 1 and
    g = 1, dY's a half, g·σ(b), is the forward's h, σ(b), rounded once in
    both."""
    y, dh = bench_glu.make_inputs(SHAPES[1], dev, seed=4)
    h, dy = bench_glu.block(gl.glu, y, dh)
    assert h.shape == (*SHAPES[1][:2], 320) and h.dtype == torch.bfloat16 and dy.shape == y.shape
    _, dz = bench_glu.block(gl.glu, y, torch.zeros_like(dh))
    assert torch.count_nonzero(dz) == 0
    ones = y.clone()
    ones[..., :320] = 1
    h1, d1 = bench_glu.block(gl.glu, ones, torch.ones_like(dh))
    assert torch.equal(d1[..., :320], h1)


def test_graph_replay_is_bitwise_the_eager_call(dev):
    """Forward and backward captured in a CUDA graph and replayed give the
    eager call's bits: h and dY."""
    y, dh = bench_glu.make_inputs(SHAPES[0], dev, seed=2)
    h_e, dy_e = bench_glu.block(gl.glu, y, dh)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            bench_glu.block(gl.glu, y, dh)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_g, dy_g = bench_glu.block(gl.glu, y, dh)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(h_g, h_e) and torch.equal(dy_g, dy_e)


def test_a_block_records_only_the_two_kernels(dev):
    """One block's GLU forward and backward, from the profiler's kernel
    records: ``glu_fwd_kernel`` and ``glu_bwd_kernel`` and no ATen
    elementwise, copy or cat kernel, as many as ``glu.launches`` counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    y, dh = bench_glu.make_inputs(SHAPES[0], dev, seed=3)
    bench_glu.block(gl.glu, y, dh)  # load the library
    torch.cuda.synchronize()
    before = gl.glu.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bench_glu.block(gl.glu, y, dh)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert len(names) == 2 and "glu_fwd_kernel" in names[0] and "glu_bwd_kernel" in names[1], names
    assert gl.glu.launches - before == len(names)


def test_the_op_raises_on_what_the_kernels_do_not_take(dev):
    """On the card the op launches or raises: f32, and a last dim that is
    not a multiple of 16, raise; it never falls back."""
    for y in (torch.zeros(2, 3, 32, device=dev), torch.zeros(2, 3, 24, device=dev, dtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            gl.glu(y)


def test_the_module_routes_bf16_in_every_mode(dev):
    """``ConvBlock`` on the card: bf16 runs its GLU through the op in train
    mode (a forward and a backward: two launches), in eval mode (a forward)
    and under a data-parallel group stand-in (world 1, its all-reduce the
    identity); f32 keeps the plain formula."""
    x = torch.randn(2, 24, 32, device=dev)

    def run(dtype, train, group=None):
        blk = be.ConvBlock(1, 32, 32, dtype, torch.Generator().manual_seed(0)).to(dev)
        before = gl.glu.launches
        out = blk(x.to(dtype, copy=True).requires_grad_(train), train, group)
        if train:
            out.sum().backward()
        return gl.glu.launches - before

    assert run(torch.bfloat16, True) == 2
    with torch.no_grad():
        assert run(torch.bfloat16, False) == 1
    assert run(torch.float32, True) == 0 and run(torch.float32, False) == 0
    mp = pytest.MonkeyPatch()
    mp.setattr(be, "all_reduce_sum", lambda t, group: t)
    try:
        assert run(torch.bfloat16, True, be.DataGroup(world=1, rank=0, device=dev)) == 2
    finally:
        mp.undo()
