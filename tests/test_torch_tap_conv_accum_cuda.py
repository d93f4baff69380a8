"""``TapConv``'s route on the card (the three taps accumulated inside the
GEMMs: ``_conv_taps_accum``, ``_conv_taps_dx_accum``) at the flagship's
conv shapes: in bf16 against the plain shifted-slice sums in f32, and from
``torch.profiler``'s kernel records, three GEMM launches for a conv's
forward and three for its dx, with no copy, pad, fill or add kernel. Marked
``cuda``; each test skips without a CUDA device (the CPU tier holds the
route against the plain sums in f32: ``test_torch_tap_conv_accum.py``).
Run on a GPU with

    python -m pytest tests/test_torch_tap_conv_accum_cuda.py -m cuda -q --noconftest
"""

import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.models import brain_encoder as be  # noqa: E402

pytestmark = pytest.mark.cuda

B, T = 256, 360
# (Cin, Cout, d): block 0's conv0 (270 channels in), a conv1 at the largest
# dilation, a conv2 (320 → 640), and d ≥ T (the centre tap alone)
SHAPES = [(270, 320, 1), (320, 320, 16), (320, 640, 2), (320, 320, 400)]
# Each output rounds to bf16 once a launch: three roundings, each at most
# 2^-8 (bf16's unit roundoff) of a partial sum; 2^-6 of the output's largest
# entry covers partials up to 4/3 of it. The f32 side sums the same bf16
# inputs.
REL = 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the accumulated route is the card's")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, cin, cout, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, cin, device=dev, generator=g).bfloat16()
    w = (torch.randn(3, cin, cout, device=dev, generator=g) / (3 * cin) ** 0.5).bfloat16()
    b = torch.randn(cout, device=dev, generator=g).bfloat16()
    gy = torch.randn(B, T, cout, device=dev, generator=g).bfloat16()
    return x, w, b, gy


def _close_to_f32(got, want):
    """``got`` within REL of ``want``'s largest entry."""
    torch.testing.assert_close(got.float(), want, atol=REL * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("cin,cout,d", SHAPES)
def test_bf16_route_matches_the_f32_plain_sums(dev, cin, cout, d):
    """Forward with the bias, dx and the bias gradient through ``TapConv``
    in bf16 against the plain functions in f32 on the same bf16 inputs."""
    x, w, b, gy = _inputs(dev, cin, cout, seed=d)
    tx, tb = x.clone().requires_grad_(), b.clone().requires_grad_()
    y = be.TapConv.apply(tx, w, d, tb)
    y.backward(gy)
    xf, wf, gf = x.float(), w.float(), gy.float()
    assert y.dtype == tx.grad.dtype == torch.bfloat16
    _close_to_f32(y, be._conv_taps(xf, wf, d) + b.float())
    _close_to_f32(tx.grad, be._conv_taps_dx(gf, wf, d))
    # one bf16 rounding of an f32 sum, as before
    torch.testing.assert_close(tb.grad.float(), gf.sum(dim=(0, 1)), atol=1e-2, rtol=2.0 ** -8)


def _kernel_names(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def _assert_gemms_only(names, n):
    """``n`` GEMM records and no kernel of torch's own (``at::native``:
    copies, pads, fills, elementwise adds). cuBLAS's cooperative GEMMs clear
    their own workspace first ("Memset (Device)"), at most one a GEMM."""
    gemms = [k for k in names if not k.startswith("Memset")]
    assert len(gemms) == n and len(names) - n <= n, names
    assert not any("at::native" in k for k in names), names


@pytest.mark.parametrize("cin,cout,d", SHAPES)
def test_a_conv_launches_three_gemms_forward_and_for_dx(dev, cin, cout, d):
    """One conv's forward (bias folded in) and one conv's dx, each from its
    kernel records: three GEMMs (one at d ≥ T) and nothing else of torch's."""
    x, w, b, gy = _inputs(dev, cin, cout)
    tx = x.clone().requires_grad_()
    n = 3 if d < T else 1
    be.TapConv.apply(tx, w, d, b)  # warm cuBLAS's handles and heuristics
    fwd = []
    _assert_gemms_only(_kernel_names(lambda: fwd.append(be.TapConv.apply(tx, w, d, b))), n)
    torch.autograd.grad(fwd[0], tx, gy, retain_graph=True)
    _assert_gemms_only(_kernel_names(lambda: torch.autograd.grad(fwd[0], tx, gy, retain_graph=True)), n)
