"""Port kernels' plain versions against the JAX Pallas kernels (interpret
mode on the CPU): K1 ``subject_matmul`` and K4 ``conv_block_fused``, plus the
kernel build module's CPU-side behaviour. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.ops.pallas import conv_block as jcb  # noqa: E402
from speech_decoding_tpu.ops.pallas.subject_conv import subject_matmul as j_subject_matmul  # noqa: E402
from speech_decoding_tpu_torch.ops import _build  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block as tcb  # noqa: E402
from speech_decoding_tpu_torch.ops.subject_conv import subject_matmul, subject_matmul_plain  # noqa: E402

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

    @pytest.mark.parametrize("cin", [16, 24])
    def test_staged_bf16_conv0_is_depth_padded(self, cin):
        """bf16 staging zero-pads conv0's depth to a multiple of 16 once; the
        wrapper's plain version reads only the first Cin rows."""
        rng = np.random.default_rng(4)
        args = [_t(a) for a in _block_args(rng, 0, cin, D)]
        w0 = tcb.stage_weight(args[0], torch.bfloat16)
        assert w0.shape == (3, tcb.conv0_depth(cin, torch.bfloat16), D) == (3, 32 if cin == 24 else 16, D)
        assert not w0[:, cin:].any()
        assert tcb.stage_weight(args[0], torch.float32).shape == (3, cin, D)
        x = _t(rng.normal(size=(B, T, cin)).astype(np.float32)).bfloat16()
        w = [a.bfloat16() if a.dim() == 3 else a for a in args]
        got = tcb.conv_block_fused(x, w0, *w[1:], k=0)
        np.testing.assert_array_equal(got.float().numpy(), tcb.conv_block_plain(x, *w, k=0).float().numpy())

    @pytest.mark.parametrize("k,expect", [(0, (1, 2)), (1, (4, 8)), (2, (16, 1)), (3, (2, 4)), (4, (8, 16))])
    def test_dilations(self, k, expect):
        assert tcb.dilations(k) == expect


class TestBuild:
    def test_library_path_is_keyed_by_source_hash(self):
        a = _build._lib_path("subject_matmul")
        b = _build._lib_path("conv_block")
        assert a != b and a.startswith(_build.BUILD_DIR)
        assert a == _build._lib_path("subject_matmul")
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)

    def test_check_raises_on_error_code(self):
        _build.check(0, "ok")
        with pytest.raises(RuntimeError, match="cudaError_t 9"):
            _build.check(9, "launch")
