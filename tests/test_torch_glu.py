"""The GLU op (``ops.glu``) on the CPU: its plain route, which ``ConvBlock``
runs where the kernels are not taken, is the reference's
``a * torch.sigmoid(b)`` with autograd's gradient, bit for bit; ``takes``
accepts what the kernels take and refuses the rest, and the op raises on
what it refuses; ``ConvBlock`` routes what ``takes`` accepts to the op
(its bits off the card, the GLU's formula among them, are held by
``test_torch_batchnorm_gelu.py``'s ``test_conv_block_keeps_todays_bits_off_the_card``);
``GLU_roofline.train``'s arithmetic; ``port_bench.step_kernels``' kinds;
and ``tools.bench_glu`` on the CPU. The
kernels themselves run on the card: ``test_torch_glu_cuda.py``.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from port_bench import cells, step_kernels  # noqa: E402
from speech_decoding_tpu_torch.models import brain_encoder as be  # noqa: E402
from speech_decoding_tpu_torch.ops import glu as gl  # noqa: E402
from speech_decoding_tpu_torch.tools import bench_glu  # noqa: E402


def _y(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3 * torch.randn(*shape, generator=g)).to(dtype)


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 17, 640), (1, 1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_route_is_the_reference_formula(dtype, shape):
    """``glu_plain`` against ``a * torch.sigmoid(b)`` on the two halves,
    bit for bit: the output and autograd's gradient of y."""
    y = _y(shape, dtype)
    dh = _y((*shape[:-1], shape[-1] // 2), dtype, seed=1)
    ya, yb = y.clone().requires_grad_(), y.clone().requires_grad_()
    got = gl.glu_plain(ya)
    a, b = yb.chunk(2, dim=-1)
    want = a * torch.sigmoid(b)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, ya, dh)[0], torch.autograd.grad(want, yb, dh)[0])


class _Like:
    """What ``takes`` reads of a tensor, for tensors this machine cannot make."""

    def __init__(self, shape, dtype=torch.bfloat16, cuda=True):
        self.shape, self.dtype, self.is_cuda = torch.Size(shape), dtype, cuda

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("like,want", [
    (_Like((256, 360, 640)), True),  # the flagship: D = 320
    (_Like((3, 17, 16)), True),  # D = 8, the smallest
    (_Like((1, 1, 4096)), True),
    (_Like((256, 360, 640), cuda=False), False),  # the CPU: the plain route
    (_Like((256, 360, 640), torch.float32), False),  # f32: the plain route
    (_Like((256, 360, 640), torch.float16), False),
    (_Like((92160, 640)), False),  # rank 2
    (_Like((2, 256, 360, 640)), False),  # rank 4
    (_Like((256, 360, 641)), False),  # odd: no halves
    (_Like((256, 360, 648)), False),  # D = 324, not a multiple of 8
    (_Like((256, 360, 8)), False),  # D = 4
    (_Like((256, 360, 0)), False),
])
def test_takes_the_kernels_inputs_alone(like, want):
    """``takes``: a bf16 (B, T, 2D) CUDA tensor with D a multiple of 8 (its
    last dim a multiple of 16), nothing else."""
    assert gl.takes(like) is want


def test_the_op_refuses_other_devices():
    """Not a CUDA tensor (the CPU, meta): ``takes`` refuses it and the op
    raises; it never runs the plain route itself."""
    for y in (torch.zeros(2, 3, 32, dtype=torch.bfloat16, device="meta"), torch.zeros(2, 3, 32, dtype=torch.bfloat16)):
        assert not gl.takes(y)
        with pytest.raises(ValueError):
            gl.glu(y)


@pytest.mark.parametrize("taken", [True, False])
def test_conv_block_routes_what_the_kernels_take_to_the_op(monkeypatch, taken):
    """``ConvBlock`` hands conv2's output to ``glu`` where ``takes`` accepts
    it (here a stand-in, as no CPU tensor is taken), and to ``glu_plain``
    where it refuses."""
    calls = []
    monkeypatch.setattr(gl, "takes", lambda y: taken)
    monkeypatch.setattr(gl, "glu", lambda y: calls.append(("op", tuple(y.shape))) or gl.glu_plain(y))
    blk = be.ConvBlock(0, 16, 16, torch.bfloat16, torch.Generator().manual_seed(0))
    out = blk(torch.randn(2, 9, 16).bfloat16(), True)
    assert out.shape == (2, 9, 16)
    assert calls == ([("op", (2, 9, 32))] if taken else [])


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_seconds(self, match):
        return sum(s for name, s in self.kernels if match(name))


@pytest.mark.parametrize("kernels,want", [
    # 0.704 ms of compulsory bytes a step at B=256 (8·B·T·D2·2 bytes over five blocks at 3.35 TB/s)
    ([("glu_fwd_kernel(uint4 const*, ...)", 0.3), ("glu_bwd_kernel(uint4 const*, ...)", 0.6),
      ("void at::native::elementwise_kernel<128, 4, ...sigmoid...>", 9.0), ("bngelu_apply_kernel", 3.0)],
     100.0 * 1000 * 5 * 8 * 256 * 360 * 320 * 2 / 3.35e12 / 0.9),
    ([("void at::native::elementwise_kernel<128, 4, ...sigmoid...>", 9.0), ("bngelu_apply_kernel", 3.0)], None),
])
def test_glu_roofline_reads_the_new_kernels_alone(kernels, want):
    """``GLU_roofline.train``: the window's steps times the five blocks'
    compulsory bytes over the device time of the ``glu_fwd`` and
    ``glu_bwd`` kernels; nothing to read (the parent's ATen chain), no
    metric."""
    read = cells.metric_reader("GLU_roofline.train")
    cell = cells.Cell("gw208-train-b256-resident")
    ctx = SimpleNamespace(trace=_Trace(kernels), counts={"steps": 1000, "batch": 256}, cfg=cell.config)
    got = read(ctx)
    assert got == pytest.approx(want) if want is not None else got is None
    assert read(SimpleNamespace(trace=None, counts={"steps": 1000, "batch": 256}, cfg=cell.config)) is None


@pytest.mark.parametrize("name,kind", [
    ("glu_fwd_kernel(uint4 const*, uint4*, int, int)", "GLU kernels"),
    ("glu_bwd_kernel(uint4 const*, uint4 const*, uint4*, int, int)", "GLU kernels"),
    ("bngelu_apply_kernel(...)", "BN + GELU kernels"),
    ("void at::native::elementwise_kernel<128, 4, ...sigmoid_kernel_cuda...>", "sigmoid"),
    ("void at::native::vectorized_elementwise_kernel<8, ...MulFunctor<float>...>", "multiplies"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<...>", "cat"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", "cuBLAS GEMMs"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reductions"),
    ("void at::native::unrolled_elementwise_kernel<...DivFunctor...>", "other elementwise"),
])
def test_step_kernels_names_each_kernels_kind(name, kind):
    """``port_bench.step_kernels``: a kernel's kind by the first pattern its
    full name matches (the GLU's own kernels before the ATen chain's), and
    the kinds' sums."""
    assert step_kernels.kind_of(name) == kind


def test_step_kernels_sums_by_kind():
    got = step_kernels.by_kind({"glu_fwd_kernel(a)": (5.0, 0.3), "glu_bwd_kernel(b)": (5.0, 0.5),
                                "void at::native::reduce_kernel<1>": (2.0, 1.0)})
    assert list(got) == ["reductions", "GLU kernels"]
    assert got["GLU kernels"] == pytest.approx({"records": 10.0, "ms": 0.8})


def test_bench_tool_runs_the_plain_version_on_the_cpu():
    """``tools.bench_glu`` on the CPU: the plain route and the library's
    (``torch.nn.functional.glu``) at a small shape, the library's the same
    formula; and its check's bound at the flagship's width: the f32 formulas
    rounded to bf16 once are within it."""
    out = bench_glu.run("cpu")
    assert out["device"] == "cpu" and out["shape"] == list(bench_glu.SMALL)
    y = _y((2, 5, 32), torch.float32)
    assert torch.allclose(bench_glu.library(y), gl.glu_plain(y), rtol=1e-6, atol=1e-7)
    y, dh = bench_glu.make_inputs((2, 7, 640), "cpu")
    h_ref, dy_ref = bench_glu.reference(y, dh)
    assert h_ref.shape == (2, 7, 320) and dy_ref.shape == y.shape
    assert bench_glu.one_rounding(h_ref.bfloat16(), h_ref) <= 1.0
    assert bench_glu.one_rounding(dy_ref.bfloat16(), dy_ref, bench_glu.dy_slack(y, dh)) <= 1.0
