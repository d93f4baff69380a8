"""``TapConv``'s card route, the three taps accumulated inside the GEMMs
(``_conv_taps_accum`` forward, ``_conv_taps_dx_accum`` for dx), against the
plain shifted-slice sums the CPU runs (``_conv_taps``, ``_conv_taps_dx``),
in f32 on the CPU: the route is stock torch (``addmm``, ``baddbmm_`` into
row-offset views), so it runs here as it does on the card. The card's
copy of these checks in bf16, with its kernel records, is
``test_torch_tap_conv_accum_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.models import brain_encoder as be  # noqa: E402
from speech_decoding_tpu_torch.ops.tap_conv import tap_conv_dw  # noqa: E402

B, T = 3, 13


def _inputs(cin, cout, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, cin, generator=g)
    w = torch.randn(3, cin, cout, generator=g) / (3 * cin) ** 0.5
    b = torch.randn(cout, generator=g)
    gy = torch.randn(B, T, cout, generator=g)
    return x.to(dtype), w.to(dtype), b.to(dtype), gy.to(dtype)


# Cin ≠ Cout as in block 0's conv0 (270 → 320) and every conv2 (320 → 640),
# at a small width; d = 16 and 20 exceed T = 13, so only the centre tap runs
@pytest.mark.parametrize("cin,cout", [(27, 32), (32, 64), (32, 32)])
@pytest.mark.parametrize("d", [1, 2, 16, 20])
def test_accumulated_route_matches_the_shifted_slice_sums(monkeypatch, cin, cout, d):
    """Forward (bias folded into the centre tap's GEMM), dx through
    ``TapConv``'s backward and the bias gradient, with the accumulated route
    forced on the CPU, against the plain functions with the bias added
    after; dW is K2's plain version on both sides. f32: only the order of
    the three taps' sums differs."""
    x, w, b, gy = _inputs(cin, cout, seed=d)
    monkeypatch.setattr(be, "_accumulates", lambda t: True)
    tx, tw, tb = (t.clone().requires_grad_() for t in (x, w, b))
    y = be.TapConv.apply(tx, tw, d, tb)
    y.backward(gy)

    torch.testing.assert_close(y.detach(), be._conv_taps(x, w, d) + b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(be._conv_taps_accum(x, w, d), be._conv_taps(x, w, d), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tx.grad, be._conv_taps_dx(gy, w, d), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(be._conv_taps_dx_accum(gy, w, d), be._conv_taps_dx(gy, w, d), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tb.grad, gy.sum(dim=(0, 1)), rtol=0, atol=0)
    torch.testing.assert_close(tw.grad, tap_conv_dw(x, gy, d), rtol=0, atol=0)


class _Unfolded(torch.autograd.Function):
    """``TapConv`` as it was before the bias moved into it: the plain
    functions, dW through K2, the bias added outside by autograd."""

    @staticmethod
    def forward(ctx, x, w, d):
        ctx.save_for_backward(x, w)
        ctx.d = d
        return be._conv_taps(x, w, d)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return be._conv_taps_dx(g, w, ctx.d), tap_conv_dw(x.contiguous(), g.contiguous(), ctx.d).to(g.dtype), None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 16])
def test_cpu_route_is_unchanged_bitwise(dtype, d):
    """On the CPU a k=3 ``Conv1d`` (bias passed into ``TapConv``) gives the
    same bits, forward and every gradient, as the plain conv with the bias
    added after it by autograd."""
    conv = be.Conv1d(27, 32, 3, d, dtype, torch.Generator().manual_seed(d))
    x, _, _, gy = _inputs(27, 32, seed=d)
    gy = gy.to(dtype)
    tx = x.clone().requires_grad_()
    y = conv(tx)
    y.backward(gy)
    got = [y.detach(), tx.grad, conv.kernel.grad, conv.bias.grad]
    conv.zero_grad(set_to_none=True)
    tx.grad = None
    y = _Unfolded.apply(tx.to(dtype), conv.kernel.to(dtype), d) + conv.bias.to(dtype)
    y.backward(gy)
    for a, e in zip(got, [y.detach(), tx.grad, conv.kernel.grad, conv.bias.grad]):
        assert a.dtype == e.dtype and torch.equal(a, e)
