"""Port kernels' plain versions against the JAX Pallas kernels (interpret
mode on the CPU): K1 ``subject_matmul`` (forward and backward), K2
``tap_conv_dw``, K3 ``retrieval_ranks``, K4 ``conv_block_fused`` and K5
``tap_conv`` (forward and VJP), plus the
collate functions and the kernel build module's CPU-side behaviour. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.ops import scaling as jsc  # noqa: E402
from speech_decoding_tpu.ops.pallas import conv_block as jcb  # noqa: E402
from speech_decoding_tpu.ops.pallas.retrieval import retrieval_ranks_pallas as j_retrieval_ranks  # noqa: E402
from speech_decoding_tpu.ops.pallas.subject_conv import subject_matmul as j_subject_matmul  # noqa: E402
from speech_decoding_tpu.ops.pallas.tap_conv import pallas_tap_conv as j_pallas_tap_conv  # noqa: E402
from speech_decoding_tpu.ops.pallas.tap_conv import tap_conv as j_tap_conv  # noqa: E402
from speech_decoding_tpu.ops.pallas.tap_conv import tap_conv_dw as j_tap_conv_dw  # noqa: E402
from speech_decoding_tpu_torch.ops import _build  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block as tcb  # noqa: E402
from speech_decoding_tpu_torch.ops.retrieval import (  # noqa: E402
    near_tie_rows, retrieval_metrics_kernel, retrieval_ranks,
)
from speech_decoding_tpu_torch.ops.scaling import (  # noqa: E402
    apply_scale_stats,
    baseline_correct,
    clamp,
    gwilliams_collate,
    robust_scale,
    window_scale_stats,
)
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul, subject_matmul_plain  # noqa: E402
from speech_decoding_tpu_torch.ops.tap_conv import (  # noqa: E402
    PallasTapConv, tap_conv, tap_conv_dw, tap_conv_dw_plain, tap_conv_plain,
)

torch.set_num_threads(1)

B, T, D, S = 4, 40, 16, 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestSubjectMatmul:
    @pytest.mark.parametrize("shape", [(B, T, D, D, S), (5, 13, 24, 8, 3)])
    def test_plain_matches_pallas(self, shape):
        b, t, din, dout, s = shape
        rng = np.random.default_rng(1)
        x = rng.normal(size=(b, t, din)).astype(np.float32)
        w = rng.normal(size=(s, din, dout)).astype(np.float32)
        ids = (np.arange(b) % s).astype(np.int32)  # every subject, mixed
        rng.shuffle(ids)
        want = np.asarray(j_subject_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids), True))
        got = subject_matmul(_t(x), _t(w), _t(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.numpy(), subject_matmul_plain(_t(x), _t(w), _t(ids)).numpy())

    @pytest.mark.parametrize("bad", [-1, S])
    def test_out_of_range_id_raises(self, bad):
        x = torch.zeros(2, 3, D)
        w = torch.zeros(S, D, D)
        with pytest.raises(ValueError, match="subject ids"):
            subject_matmul(x, w, torch.tensor([0, bad], dtype=torch.int32))

    def test_cpu_call_launches_nothing(self):
        before = subject_matmul.launches
        subject_matmul(torch.ones(1, 2, D), torch.ones(S, D, D), torch.zeros(1, dtype=torch.int32))
        assert subject_matmul.launches == before

    def test_shape_errors(self):
        with pytest.raises(ValueError, match="shapes"):
            subject_matmul(torch.zeros(2, 3, D), torch.zeros(S, D + 1, D), torch.zeros(2, dtype=torch.int32))
        with pytest.raises(ValueError, match="subject_idxs"):
            subject_matmul(torch.zeros(2, 3, D), torch.zeros(S, D, D), torch.zeros(3, dtype=torch.int32))


def _block_args(rng, k, cin, d2):
    """Random block weights and random (non-trivial) BN stats, folded."""
    w0 = rng.normal(size=(3, cin, d2)).astype(np.float32) / np.sqrt(3 * cin)
    w1 = rng.normal(size=(3, d2, d2)).astype(np.float32) / np.sqrt(3 * d2)
    w2 = rng.normal(size=(3, d2, 2 * d2)).astype(np.float32) / np.sqrt(3 * d2)
    b0, b1 = (0.1 * rng.normal(size=d2).astype(np.float32) for _ in range(2))
    b2 = 0.1 * rng.normal(size=2 * d2).astype(np.float32)
    folds = []
    for _ in range(2):
        p = {"scale": rng.uniform(0.5, 1.5, d2).astype(np.float32),
             "bias": rng.normal(size=d2).astype(np.float32) * 0.1}
        st = {"mean": rng.normal(size=d2).astype(np.float32) * 0.2,
              "var": rng.uniform(0.5, 2.0, d2).astype(np.float32)}
        folds.append(jcb.fold_bn(p, st))
    return [w0, b0, folds[0], w1, b1, folds[1], w2, b2]


class TestConvBlock:
    @pytest.mark.parametrize("k", range(5))
    def test_plain_matches_pallas(self, k):
        """T=40 < 2·(d0+d1+2) for k=2 and k=4: the widest dilations reach
        both edges, so each conv's own zero padding is exercised."""
        rng = np.random.default_rng(10 + k)
        args = _block_args(rng, k, D, D)
        x = rng.normal(size=(B, T, D)).astype(np.float32)
        want = np.asarray(jcb.conv_block_fused(jnp.asarray(x), *map(jnp.asarray, args), k=k, interpret=True))
        got = tcb.conv_block_fused(_t(x), *map(_t, args), k=k)
        assert got.shape == (B, T, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    def test_fold_bn_equals_jax(self):
        rng = np.random.default_rng(3)
        p = {"scale": rng.uniform(0.5, 1.5, 7).astype(np.float32), "bias": rng.normal(size=7).astype(np.float32)}
        st = {"mean": rng.normal(size=7).astype(np.float32), "var": rng.uniform(0.1, 2, 7).astype(np.float32)}
        got = tcb.fold_bn(_t(p["scale"]), _t(p["bias"]), _t(st["mean"]), _t(st["var"]))
        np.testing.assert_array_equal(got.numpy(), jcb.fold_bn(p, st))

    @pytest.mark.parametrize("cin", [16, 27])
    def test_staged_bf16_conv0_is_depth_padded(self, cin):
        """bf16 staging lays conv0's weight out K-major with its depth
        zero-padded to a multiple of 8 once; the wrapper's plain version reads
        only the first Cin columns, and the bf16 images give the bits of the
        same weights staged in f32."""
        rng = np.random.default_rng(4)
        args = [_t(a) for a in _block_args(rng, 0, cin, D)]
        w0 = tcb.stage_weight(args[0], torch.bfloat16)
        assert w0.shape == (3, D, tcb.conv0_depth(cin, torch.bfloat16)) == (3, D, 32 if cin == 27 else 16)
        assert not w0[..., cin:].any()
        assert tcb.stage_weight(args[0], torch.float32).shape == (3, cin, D)
        x = _t(rng.normal(size=(B, T, cin)).astype(np.float32)).bfloat16()
        w16 = [w0, args[1], args[2], tcb.stage_weight(args[3], torch.bfloat16), args[4], args[5],
               tcb.stage_weight(args[6], torch.bfloat16, glu=True), args[7]]
        w32 = [a.bfloat16().float() if a.dim() == 3 else a for a in args]  # the same bf16 values, f32 layout
        got = tcb.conv_block_fused(x, *w16, k=0)
        np.testing.assert_array_equal(got.float().numpy(), tcb.conv_block_plain(x, *w32, k=0).float().numpy())

    @pytest.mark.parametrize("k,expect", [(0, (1, 2)), (1, (4, 8)), (2, (16, 1)), (3, (2, 4)), (4, (8, 16))])
    def test_dilations(self, k, expect):
        assert tcb.dilations(k) == expect


class TestBuild:
    def test_library_path_is_keyed_by_source_hash(self):
        a = _build._lib_path("subject_matmul")
        b = _build._lib_path("conv_block")
        assert a != b and a.startswith(_build.BUILD_DIR)
        assert len({_build._lib_path(n) for n in ("tap_conv_dw", "retrieval_ranks", "subject_matmul", "tap_conv",
                                                   "conv_block_train")}) == 5
        assert a == _build._lib_path("subject_matmul")
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)

    def test_check_raises_on_error_code(self):
        _build.check(0, "ok")
        with pytest.raises(RuntimeError, match="cudaError_t 9"):
            _build.check(9, "launch")


class TestSubjectMatmulGrad:
    """K1 backward: the port's autograd grads against ``jax.vjp`` of the
    Pallas ``subject_matmul`` (interpret mode), f32, atol 1e-5 of values of
    order 10 (sums in another order)."""

    @pytest.mark.parametrize("shape", [(B, T, D, D, S), (5, 13, 24, 8, 3)])
    def test_grads_match_jax_vjp(self, shape):
        b, t, din, dout, s = shape
        rng = np.random.default_rng(2)
        x = rng.normal(size=(b, t, din)).astype(np.float32)
        w = rng.normal(size=(s, din, dout)).astype(np.float32)
        g = rng.normal(size=(b, t, dout)).astype(np.float32)
        ids = (np.arange(b) % s).astype(np.int32)
        rng.shuffle(ids)
        _, vjp = jax.vjp(lambda a, c: j_subject_matmul(a, c, jnp.asarray(ids), True), jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = (np.asarray(v) for v in vjp(jnp.asarray(g)))
        tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
        subject_matmul(tx, tw, _t(ids)).backward(_t(g))
        np.testing.assert_allclose(tx.grad.numpy(), jdx, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), jdw, rtol=0, atol=1e-5)

    def test_unused_subject_gets_zero_grad(self):
        x = torch.ones(2, 3, D, requires_grad=True)
        w = torch.ones(S + 1, D, D, requires_grad=True)
        subject_matmul(x, w, torch.tensor([0, 0], dtype=torch.int32)).sum().backward()
        assert float(w.grad[1:].abs().sum()) == 0 and float(w.grad[0].abs().sum()) > 0


class TestTapConvDw:
    """K2's plain version against the Pallas ``tap_conv_dw`` in interpret mode
    (f32, rtol 1e-5 / atol 1e-4 for sums of ~100 products of order 1)."""

    @pytest.mark.parametrize("d", [1, 2, 4, 16])
    @pytest.mark.parametrize("t", [T, 16])
    def test_plain_matches_pallas(self, d, t):
        """T=16 with d=16: d >= T, so the shifted taps see no valid row (the
        Pallas kernel slices x[:, :T-d], so it takes d <= T only)."""
        rng = np.random.default_rng(d + t)
        x = rng.normal(size=(3, t, 20)).astype(np.float32)
        g = rng.normal(size=(3, t, 12)).astype(np.float32)
        want = np.asarray(j_tap_conv_dw(jnp.asarray(x), jnp.asarray(g), d, interpret=True))
        got = tap_conv_dw(_t(x), _t(g), d)
        assert got.shape == (3, 20, 12) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
        if d >= t:
            assert not got[0].any() and not got[2].any()

    def test_dilation_past_the_recording_matches_jax_vjp(self):
        """d=16 > T=13: against the dW of JAX's ``_gemm_conv`` VJP (its
        einsum taps, which take any d); atol 1e-4."""
        from speech_decoding_tpu.models.brain_encoder import _gemm_conv

        rng = np.random.default_rng(3)
        x = rng.normal(size=(3, 13, 20)).astype(np.float32)
        w = rng.normal(size=(3, 20, 12)).astype(np.float32)
        g = rng.normal(size=(3, 13, 12)).astype(np.float32)
        _, vjp = jax.vjp(lambda a, c: _gemm_conv(a, c, 16, True), jnp.asarray(x), jnp.asarray(w))
        want = np.asarray(vjp(jnp.asarray(g))[1])
        got = tap_conv_dw(_t(x), _t(g), 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
        assert not got[0].any() and not got[2].any()

    def test_bf16_inputs_accumulate_in_f32(self):
        rng = np.random.default_rng(0)
        x = _t(rng.normal(size=(2, 9, 8)).astype(np.float32)).bfloat16()
        g = _t(rng.normal(size=(2, 9, 5)).astype(np.float32)).bfloat16()
        got = tap_conv_dw(x, g, 2)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), tap_conv_dw_plain(x.float(), g.float(), 2).numpy())

    def test_cpu_call_launches_nothing_and_shape_errors(self):
        before = tap_conv_dw.launches
        tap_conv_dw(torch.ones(1, 4, 3), torch.ones(1, 4, 2), 1)
        assert tap_conv_dw.launches == before
        with pytest.raises(ValueError, match="shapes"):
            tap_conv_dw(torch.ones(1, 4, 3), torch.ones(1, 5, 2), 1)
        with pytest.raises(ValueError, match="dilation"):
            tap_conv_dw(torch.ones(1, 4, 3), torch.ones(1, 4, 2), 0)


# (B, T, Cin, Cout), dilation: tests/test_pallas.py's shapes for the JAX kernel
K5_CASES = [((3, 16, 8, 6), 2), ((4, 24, 12, 10), 1), ((4, 24, 12, 10), 4)]


class TestTapConv:
    """K5's plain version and ``PallasTapConv`` against the Pallas
    ``tap_conv`` and ``pallas_tap_conv`` in interpret mode (f32; the forward
    at rtol 1e-5 / atol 1e-5, the gradients, sums over all rows, at atol 1e-4)."""

    @staticmethod
    def _inputs(shape, d):
        b, t, cin, cout = shape
        rng = np.random.default_rng(b + t + d)
        return (rng.normal(size=(b, t, cin)).astype(np.float32),
                (0.2 * rng.normal(size=(3, cin, cout))).astype(np.float32),
                rng.normal(size=(b, t, cout)).astype(np.float32))

    @pytest.mark.parametrize("shape,d", K5_CASES)
    def test_plain_matches_pallas(self, shape, d):
        x, w, _ = self._inputs(shape, d)
        want = np.asarray(j_tap_conv(jnp.asarray(x), jnp.asarray(w), d, interpret=True))
        got = tap_conv(_t(x), _t(w), d)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape,d", K5_CASES)
    def test_vjp_matches_pallas(self, shape, d):
        x, w, gy = self._inputs(shape, d)
        _, vjp = jax.vjp(lambda a, c: j_pallas_tap_conv(a, c, d, True), jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = (np.asarray(v) for v in vjp(jnp.asarray(gy)))
        tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
        PallasTapConv.apply(tx, tw, d).backward(_t(gy))
        np.testing.assert_allclose(tx.grad.numpy(), jdx, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tw.grad.numpy(), jdw, rtol=1e-5, atol=1e-4)

    def test_rounds_once_and_domain(self):
        """bf16 in: the three taps add in f32 and round once; d must lie in
        (0, T), as the JAX kernel asserts; a CPU call launches nothing."""
        rng = np.random.default_rng(0)
        x = _t(rng.normal(size=(2, 9, 8)).astype(np.float32)).bfloat16()
        w = _t(rng.normal(size=(3, 8, 5)).astype(np.float32)).bfloat16()
        before = tap_conv.launches
        got = tap_conv(x, w, 2)
        assert tap_conv.launches == before and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), tap_conv_plain(x.float(), w.float(), 2).bfloat16().float().numpy())
        for d in (0, 9, 12):
            with pytest.raises(ValueError, match="dilation"):
                tap_conv(x, w, d)
        with pytest.raises(ValueError, match="shapes"):
            tap_conv(x, w[:, :4], 1)


class TestRetrievalRanks:
    """K3's plain version against the Pallas ``retrieval_ranks_pallas`` in
    interpret mode: ranks equal (the inputs have no near-ties)."""

    @pytest.mark.parametrize("b,f,t", [(12, 8, 5), (130, 3, 7)])
    def test_plain_matches_pallas(self, b, f, t):
        """B=130 pads to two 128-row Pallas tiles; D=21 is not a multiple of its depth tile."""
        rng = np.random.default_rng(b)
        Y = rng.normal(size=(b, f, t)).astype(np.float32)
        Z = (0.1 * Y + rng.normal(size=(b, f, t))).astype(np.float32)
        want = np.asarray(j_retrieval_ranks(jnp.asarray(Z), jnp.asarray(Y), interpret=True))
        got = retrieval_ranks(_t(Z), _t(Y))
        assert got.dtype == torch.int32 and got.shape == (b,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(np.unique(want)) > 3  # ranks spread
        top1, top10 = retrieval_metrics_kernel(_t(Z), _t(Y))
        np.testing.assert_allclose(float(top1), np.mean(want < 1))
        np.testing.assert_allclose(float(top10), np.mean(want < 10))

    def test_diagonal_never_counts(self):
        Y = torch.ones(4, 3)
        assert retrieval_ranks(Y.clone(), Y).tolist() == [0, 0, 0, 0]  # all equal: nothing strictly greater

    def test_near_tie_rows(self):
        """Row 0's diagonal equals its column 1 (both cos 1/√2); rows 1 and 2
        beat every other column by more than 0.29."""
        e = torch.eye(3)
        Y = torch.stack([e[0], e[2], e[1]])
        Z = torch.stack([e[0] + e[1], e[0] + e[2], e[1]])
        assert near_tie_rows(Z, Y) == {0}
        assert near_tie_rows(Z, Y, tol=0.0) == set()  # |Δ| < 0 holds nowhere
        assert near_tie_rows(Z, Y, tol=0.8) == {0, 1, 2}

    def test_cpu_call_launches_nothing_and_shape_errors(self):
        before = retrieval_ranks.launches
        retrieval_ranks(torch.randn(3, 4), torch.randn(3, 2, 2))
        assert retrieval_ranks.launches == before
        with pytest.raises(ValueError, match="row"):
            retrieval_ranks(torch.randn(3, 4), torch.randn(2, 4))


class TestScaling:
    """The collate functions against the JAX package's (f32, rtol 1e-5: the
    same quantile interpolation, sums in another order)."""

    @staticmethod
    def _x(seed=0, shape=(3, 5, 40)):
        rng = np.random.default_rng(seed)
        x = (rng.normal(size=shape) * 10 + 3).astype(np.float32)
        x[0, 1] = 2.5  # a flat channel: IQR 0 -> 1
        return x

    def test_robust_scale_and_stats(self):
        x = self._x()
        np.testing.assert_allclose(robust_scale(_t(x)).numpy(), np.asarray(jsc.robust_scale(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)
        got = window_scale_stats(_t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jsc.window_scale_stats(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
        assert got[0, 1, 1] == 1.0

    @pytest.mark.parametrize("do_clamp", [True, False])
    def test_collate_and_precomputed_stats(self, do_clamp):
        x = self._x(1)
        want = np.asarray(jsc.gwilliams_collate(jnp.asarray(x), 10, 2.0, do_clamp))
        got = gwilliams_collate(_t(x), 10, 2.0, do_clamp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        stats = window_scale_stats(_t(x))
        np.testing.assert_allclose(apply_scale_stats(_t(x), stats, 2.0, do_clamp).numpy(), want,
                                   rtol=1e-5, atol=1e-4)
        xl = _t(np.swapaxes(x, 1, 2).copy())
        js = jnp.asarray(stats.numpy())
        np.testing.assert_allclose(
            apply_scale_stats(xl, stats, 2.0, do_clamp, channels_last=True).numpy(),
            np.asarray(jsc.apply_scale_stats(jnp.asarray(xl.numpy()), js, 2.0, do_clamp, channels_last=True)),
            rtol=1e-6, atol=1e-6)

    def test_clamp_and_baseline(self):
        x = self._x(2)
        np.testing.assert_array_equal(clamp(_t(x), 4.0).numpy(), np.asarray(jsc.clamp(jnp.asarray(x), 4.0)))
        np.testing.assert_allclose(baseline_correct(_t(x), 7).numpy(),
                                   np.asarray(jsc.baseline_correct(jnp.asarray(x), 7)), rtol=1e-6, atol=1e-5)
