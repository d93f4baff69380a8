"""The port's BrainEncoder (eval) against the flax BrainEncoder through the
params bridge, and the bridge / torch-checkpoint import against the JAX
package's."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu.models.torch_port import brain_encoder_from_torch as jax_from_torch  # noqa: E402
from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d as t_ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, fourier_bases  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import flax_from_state, load_flax  # noqa: E402
from speech_decoding_tpu_torch.models.torch_port import brain_encoder_from_torch  # noqa: E402

torch.set_num_threads(1)

B, C, T, D, F, K, S = 4, 208, 40, 16, 16, 4, 2
KW = dict(num_subjects=S, D1=D, D2=D, F=F, K=K)


@pytest.fixture(scope="module")
def flax_model():
    """flax params and (randomized, non-trivial) BN running stats as numpy."""
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    enc = JaxEncoder(loc=loc, **KW)
    X = np.zeros((2, C, T), np.float32)
    v = enc.init(jax.random.PRNGKey(0), jnp.asarray(X), jnp.zeros((2,), jnp.int32))
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else 0.2 * rng.normal(size=a.shape)).astype(np.float32),
        v["batch_stats"],
    )
    return loc, jax.tree.map(np.asarray, v["params"]), stats


def _inputs(seed, layout_last=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, C, T)).astype(np.float32)
    ids = np.array([1, 0, 1, 0], np.int32)
    return (np.swapaxes(X, -1, -2).copy() if layout_last else X), ids


@pytest.mark.parametrize("channels_last", [False, True])
def test_encoder_eval_matches_flax(flax_model, channels_last):
    loc, params, stats = flax_model
    X, ids = _inputs(0, channels_last)
    jenc = JaxEncoder(loc=loc, channels_last_io=channels_last, **KW)
    want = np.asarray(jenc.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(X), jnp.asarray(ids), train=False))
    tenc = load_flax(BrainEncoder(loc=loc, channels_last_io=channels_last, **KW), params, stats).eval()
    with torch.no_grad():
        got = tenc(torch.from_numpy(X), torch.from_numpy(ids)).numpy()
    assert got.shape == ((B, T, F) if channels_last else (B, F, T))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_bridge_round_trip(flax_model):
    loc, params, stats = flax_model
    tenc = load_flax(BrainEncoder(loc=loc, **KW), params, stats)
    p2, s2 = flax_from_state(tenc)
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(stats)
    for a, b in zip(jax.tree.leaves(p2) + jax.tree.leaves(s2), jax.tree.leaves(params) + jax.tree.leaves(stats)):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_missing_leaf(flax_model):
    loc, params, stats = flax_model
    params = dict(params)
    params.pop("conv_final2")
    with pytest.raises(RuntimeError, match="conv_final2"):
        load_flax(BrainEncoder(loc=loc, **KW), params, stats)


def test_init_is_torch_default_and_seeded():
    loc = t_ch_locations_2d("Gwilliams2022", cache=False)
    a = BrainEncoder(loc=loc, generator=torch.Generator().manual_seed(3), **KW)
    b = BrainEncoder(loc=loc, generator=torch.Generator().manual_seed(3), **KW)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.conv1.conv0.kernel.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(3 * D)
    z = a.subject_block.spatial_attention.z_re.detach()
    assert 0.0 <= float(z.min()) and float(z.max()) <= 1.0


def test_fourier_bases_bit_identical(flax_model):
    from speech_decoding_tpu.models.brain_encoder import SpatialAttention as JaxSA

    loc = flax_model[0]
    want = JaxSA(D, K, 0.1, loc)._bases()
    got = fourier_bases(loc, K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_layout_copy_matches():
    np.testing.assert_array_equal(
        t_ch_locations_2d("Gwilliams2022", cache=False), ch_locations_2d("Gwilliams2022", cache=False)
    )
    np.testing.assert_array_equal(
        t_ch_locations_2d("Brennan2018", cache=False), ch_locations_2d("Brennan2018", cache=False)
    )


def _reference_state_dict(rng, S_=3, D1=12, D2=10, F_=8, K_=2):
    sd = {"subject_block.spatial_attention.z": torch.complex(
        torch.from_numpy(rng.normal(size=(D1, K_ * K_)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(D1, K_ * K_)).astype(np.float32)))}
    def r(*s):  # conv weights (out, in, k) scaled by 1/sqrt(in·k), as trained ones are
        a = rng.normal(size=s).astype(np.float32)
        return torch.from_numpy(a / np.sqrt(s[1] * s[2]) if len(s) == 3 else a)

    sd["subject_block.conv.weight"], sd["subject_block.conv.bias"] = r(D1, D1, 1), r(D1)
    for s in range(S_):
        sd[f"subject_block.subject_layer.{s}.weight"] = r(D1, D1, 1)
    for k in range(5):
        cin = D1 if k == 0 else D2
        for name, (o, i) in {"conv0": (D2, cin), "conv1": (D2, D2), "conv2": (2 * D2, D2)}.items():
            sd[f"conv_blocks.conv{k}.{name}.weight"] = r(o, i, 3)
            sd[f"conv_blocks.conv{k}.{name}.bias"] = r(o)
        for bn in ("batchnorm0", "batchnorm1"):
            for leaf in ("weight", "bias", "running_mean"):
                sd[f"conv_blocks.conv{k}.{bn}.{leaf}"] = r(D2)
            sd[f"conv_blocks.conv{k}.{bn}.running_var"] = torch.from_numpy(
                rng.uniform(0.5, 1.5, D2).astype(np.float32))
    sd["conv_final1.weight"], sd["conv_final1.bias"] = r(2 * D2, D2, 1), r(2 * D2)
    sd["conv_final2.weight"], sd["conv_final2.bias"] = r(F_, 2 * D2, 1), r(F_)
    return sd


def test_torch_checkpoint_import_matches_jax_copy():
    sd = _reference_state_dict(np.random.default_rng(2))
    p, s, dims = brain_encoder_from_torch(sd)
    jp, js, jdims = jax_from_torch(sd)
    assert dims == jdims == {"S": 3, "D1": 12, "D2": 10, "F": 8, "K": 2}
    for a, b in zip(jax.tree.leaves((p, s)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a, b)
    # and it loads into the port's encoder at those dims
    loc = t_ch_locations_2d("Brennan2018", cache=False)
    enc = BrainEncoder(num_subjects=3, loc=loc, D1=12, D2=10, F=8, K=2)
    load_flax(enc, p, s)


def test_from_config():
    cfg = load_config(None, ["D1=16", "D2=16", "K=4", "tpu.compute_dtype=float32"])
    loc = t_ch_locations_2d("Gwilliams2022", cache=False)
    enc = BrainEncoder.from_config(cfg, loc, num_subjects=S)
    assert enc.F == 1024  # preprocs.last4layers forces F=1024 [ref: models.py:176]
    assert enc.compute_dtype == torch.float32
    # tpu.use_pallas picks the JAX package's TPU kernels; the port does not read it
    cfg = load_config(None, ["preprocs.last4layers=false", "F=24", "tpu.use_pallas=false"])
    enc = BrainEncoder.from_config(cfg, loc, num_subjects=S)
    assert enc.F == 24 and enc.compute_dtype == torch.bfloat16
