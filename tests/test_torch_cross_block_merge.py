"""K7, the F3+F1 cross-block merge, against the JAX package on the CPU:
``ops.conv_block_train.f31_plain`` against the Pallas body ``_f31_kernel``
of ``tools/bench_cross_block_merge.py``, built as that tool builds it and
run in interpret mode, for every block boundary (k_next 1..4, d0n 4, 16, 2,
8; at T=37, d0n=16 > T/2 reaches both edges). f32 throughout. The port's
tool runs its equivalence check on the plain versions."""

import functools
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speech_decoding_tpu.ops.pallas.conv_block_train import _full, _pick_rows, _row  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block_train as tcbt  # noqa: E402
from speech_decoding_tpu_torch.tools import bench_cross_block_merge as tool  # noqa: E402
from tools.bench_cross_block_merge import _f31_kernel  # noqa: E402

torch.set_num_threads(1)

B, T, C = 4, 37, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "y1": rng.normal(size=(B, T, C)).astype(np.float32),
        "mi1": np.stack([0.1 * rng.normal(size=C), 0.5 + rng.uniform(size=C)]).astype(np.float32),
        "gb1": np.stack([0.5 + rng.uniform(size=C), 0.1 * rng.normal(size=C)]).astype(np.float32),
        "w2": (rng.normal(size=(3, C, 2 * C)) / np.sqrt(3 * C)).astype(np.float32),
        "b2": (0.1 * rng.normal(size=2 * C)).astype(np.float32),
        "w0n": (rng.normal(size=(3, C, C)) / np.sqrt(3 * C)).astype(np.float32),
        "b0n": (0.1 * rng.normal(size=C)).astype(np.float32),
    }


def _jax_f31(x, d0n):
    """The merged Pallas kernel as tools/bench_cross_block_merge.py:109-122
    builds it, in interpret mode."""
    R = _pick_rows(B)
    f31 = pl.pallas_call(
        functools.partial(_f31_kernel, d0n=d0n),
        grid=(B // R,),
        in_specs=[_row(R, T, C), _full((2, C)), _full((2, C)), _full((3, C, 2 * C)), _full((1, 2 * C)),
                  _full((3, C, C)), _full((1, C))],
        out_specs=[_row(R, T, C), _row(R, T, C), _full((2, C))],
        out_shape=[jax.ShapeDtypeStruct((B, T, C), jnp.float32), jax.ShapeDtypeStruct((B, T, C), jnp.float32),
                   jax.ShapeDtypeStruct((2, C), jnp.float32)],
        interpret=True,
    )
    return [np.asarray(a) for a in f31(*(jnp.asarray(x[k]) for k in ("y1", "mi1", "gb1", "w2")),
                                       jnp.asarray(x["b2"])[None], jnp.asarray(x["w0n"]), jnp.asarray(x["b0n"])[None])]


@pytest.mark.parametrize("k_next", [1, 2, 3, 4])
def test_f31_plain_matches_jax_pallas_body(k_next):
    """out and y0n within 1e-5 of their largest entry + 1e-5 relative, s0n
    within 1e-5 relative (f32: sums in another order; the erf differs by at
    most 1.5e-7, torch.erf against the kernel's Abramowitz–Stegun form)."""
    d0n = tcbt.next_conv0_dilation(k_next)
    assert d0n == 2 ** ((2 * k_next) % 5)
    x = _inputs(k_next)
    want = _jax_f31(x, d0n)
    got = tcbt.f31(*(torch.from_numpy(x[k]) for k in ("y1", "mi1", "gb1", "w2", "b2", "w0n", "b0n")), k_next)
    assert tcbt.f31.launches == 0  # CPU tensors take the plain version
    for name, g, w in zip(("out", "y0n"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-5, atol=0, err_msg="s0n")


@pytest.mark.parametrize("k_next", [1, 2, 3, 4])
def test_f31_plain_is_the_split_pair(k_next):
    """f31_plain equals f3_plain then f1_plain bit for bit."""
    x = {k: torch.from_numpy(v) for k, v in _inputs(10 + k_next).items()}
    out, y0n, s0n = tcbt.f31_plain(*x.values(), k_next)
    o = tcbt.f3_plain(x["y1"], x["mi1"], x["gb1"], x["w2"], x["b2"])
    y, s = tcbt.f1_plain(o, x["w0n"], x["b0n"], k_next)
    assert torch.equal(out, o) and torch.equal(y0n, y) and torch.equal(s0n, s)


@pytest.mark.parametrize("k_next", [0, 5])
def test_f31_rejects_a_boundary_that_does_not_exist(k_next):
    x = {k: torch.from_numpy(v) for k, v in _inputs(0).items()}
    with pytest.raises(ValueError, match="k_next"):
        tcbt.f31(*x.values(), k_next)


def test_tool_checks_equivalence_on_the_cpu(capsys):
    """The tool draws the JAX tool's inputs (np.random.default_rng(0), same
    order) and, on the CPU, checks the merge on the plain versions only."""
    res = tool.run("cpu")
    assert res["out_y0n_bitwise_equal"] and res["s0n_bitwise_equal"] and res["d0n"] == 4
    assert res["shape"] == list(tool.SMALL) and "merged_ms" not in res
    assert "equivalence only" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    y1 = rng.normal(size=tool.SMALL)
    x = tool.make_inputs(*tool.SMALL, torch.float32, "cpu")
    np.testing.assert_array_equal(x["y1"].numpy(), y1.astype(np.float32))
    assert x["b2"].shape == (2 * tool.SMALL[2],) and x["w0n"].dtype == torch.float32


def test_tool_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.run()
