"""The port's BrainEncoder (eval and train mode), its pieces (train-mode BN,
the tap conv's custom backward, spatial dropout), the CLIP loss and the
retrieval metrics against the JAX package's, through the params bridge; and
the bridge / torch-checkpoint import against the JAX package's."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu.models import classifier as jcls  # noqa: E402
from speech_decoding_tpu.models.loss import clamped_exp as j_clamped_exp  # noqa: E402
from speech_decoding_tpu.models.loss import clamped_log as j_clamped_log  # noqa: E402
from speech_decoding_tpu.models.loss import clip_logits as j_clip_logits  # noqa: E402
from speech_decoding_tpu.models.loss import clip_loss as j_clip_loss  # noqa: E402
from speech_decoding_tpu.models.loss import mse_loss as j_mse_loss  # noqa: E402
from speech_decoding_tpu.models.torch_port import brain_encoder_from_torch as jax_from_torch  # noqa: E402
from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d as t_ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import (  # noqa: E402
    BrainEncoder,
    Conv1d,
    TapConv,
    TorchBatchNorm,
    dropout_mask_at,
    fourier_bases,
    spatial_dropout_mask,
)
from speech_decoding_tpu_torch.models.classifier import (  # noqa: E402
    Classifier,
    cosine_similarity_matrix,
    retrieval_accuracy_from_similarity,
    retrieval_metrics,
)
from speech_decoding_tpu_torch.models.loss import (  # noqa: E402
    CLIPLoss,
    clamped_exp,
    clamped_log,
    clip_logits,
    clip_loss,
    mse_loss,
)
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


# -- train mode ------------------------------------------------------------------


@pytest.mark.parametrize("channels_last", [False, True])
def test_encoder_train_forward_matches_flax(flax_model, channels_last):
    """Train mode with the mask JAX draws (sown as intermediates/drop_mask):
    outputs at rtol 1e-4 / atol 1e-5 and the new running stats at rtol 1e-5 /
    atol 1e-6 (f32; batch statistics over 160 rows, sums in another order)."""
    loc, params, stats = flax_model
    X, ids = _inputs(1, channels_last)
    X = X * 5 + 1  # away from the running stats, so the batch statistics matter
    jenc = JaxEncoder(loc=loc, channels_last_io=channels_last, use_pallas=True, conv_impl="gemm_pdw", **KW)
    want, mut = jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(X), jnp.asarray(ids),
                           train=True, mutable=["batch_stats", "intermediates"],
                           rngs={"dropout": jax.random.PRNGKey(4)})
    mask = np.array(mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0])
    assert 0 < mask.sum() < C
    tenc = load_flax(BrainEncoder(loc=loc, channels_last_io=channels_last, **KW), params, stats)
    got = tenc(torch.from_numpy(X), torch.from_numpy(ids), train=True, drop_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _, new_stats = flax_from_state(tenc)
    for a, b in zip(jax.tree.leaves(new_stats), jax.tree.leaves(mut["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="train mode"):
        tenc(torch.from_numpy(X), torch.from_numpy(ids), drop_mask=torch.from_numpy(mask))


def test_train_forward_draws_a_mask_from_the_generator(flax_model):
    loc, params, stats = flax_model
    X, ids = _inputs(2)
    tenc = load_flax(BrainEncoder(loc=loc, **KW), params, stats)
    a = tenc(torch.from_numpy(X), torch.from_numpy(ids), train=True, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    mask = spatial_dropout_mask(gen, loc, 0.1)
    tenc = load_flax(BrainEncoder(loc=loc, **KW), params, stats)
    b = tenc(torch.from_numpy(X), torch.from_numpy(ids), train=True, drop_mask=mask)
    assert torch.equal(a, b)


def test_batchnorm_train_matches_flax():
    """Batch statistics (f32 mean and E[x²] − mean²), the unbiased running
    update with momentum 0.1, and the gradient through the statistics
    (rtol 1e-5 / atol 1e-6)."""
    from speech_decoding_tpu.models.brain_encoder import TorchBatchNorm as JaxBN

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 9, 6)) * 3 + 2).astype(np.float32)
    g = rng.normal(size=(4, 9, 6)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32), "bias": rng.normal(size=6).astype(np.float32)}
    st = {"mean": rng.normal(size=6).astype(np.float32), "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    bn = JaxBN(6)

    def f(xx, pp):
        return bn.apply({"params": pp, "batch_stats": st}, xx, False, mutable=["batch_stats"])

    want, mut = f(jnp.asarray(x), p)
    _, vjp = jax.vjp(lambda xx, pp: f(xx, pp)[0], jnp.asarray(x), p)
    jdx, jdp = vjp(jnp.asarray(g))
    tbn = TorchBatchNorm(6)
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in {**p, **st}.items()})
    tx = torch.from_numpy(x).requires_grad_()
    y = tbn(tx, train=True)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(), np.asarray(mut["batch_stats"][k]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.scale.grad.numpy(), np.asarray(jdp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.bias.grad.numpy(), np.asarray(jdp["bias"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 4, 16])
def test_tap_conv_matches_jax_gemm_conv_vjp(d):
    """``TapConv`` (forward, dx and dW) against ``jax.vjp`` of the JAX
    ``_gemm_conv`` with pallas_dw (its einsum taps off the TPU); f32, atol
    1e-4 on sums of ~60 products of order 1. T=13 < d=16 included."""
    from speech_decoding_tpu.models.brain_encoder import _gemm_conv

    rng = np.random.default_rng(d)
    x = rng.normal(size=(3, 13, 10)).astype(np.float32)
    w = rng.normal(size=(3, 10, 7)).astype(np.float32)
    g = rng.normal(size=(3, 13, 7)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, c: _gemm_conv(a, c, d, True), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = TapConv.apply(tx, tw, d)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-4)


def test_spatial_dropout_mask_matches_jax_for_the_same_centre():
    from speech_decoding_tpu.models.brain_encoder import spatial_dropout_mask as j_mask

    loc = ch_locations_2d("Gwilliams2022", cache=False)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        centre = int(jax.random.randint(key, (), 0, loc.shape[0]))
        want = np.asarray(j_mask(key, jnp.asarray(loc, jnp.float32), 0.1))
        np.testing.assert_array_equal(dropout_mask_at(loc, centre, 0.1).numpy(), want)
    gen = torch.Generator().manual_seed(3)
    centre = int(torch.randint(0, loc.shape[0], (), generator=torch.Generator().manual_seed(3)))
    np.testing.assert_array_equal(spatial_dropout_mask(gen, loc, 0.1).numpy(), dropout_mask_at(loc, centre, 0.1).numpy())


def test_conv1d_takes_kernel_sizes_1_and_3_only():
    with pytest.raises(ValueError, match="kernel_size"):
        Conv1d(4, 4, 5)


def test_from_config_conv_impl_and_remat():
    loc = t_ch_locations_2d("Gwilliams2022", cache=False)
    for impl in ("xla", "gemm", "gemm_pdw", "gemm_wide"):
        cfg = load_config(None, ["D1=16", "D2=16", "K=4", f"tpu.conv_impl={impl}"])
        assert BrainEncoder.from_config(cfg, loc, num_subjects=S).d_drop == cfg.d_drop
    taps = BrainEncoder.from_config(load_config(None, ["D1=16", "D2=16", "K=4", "tpu.conv_impl=pallas_taps"]), loc,
                                    num_subjects=S)
    convs = [getattr(blk, f"conv{i}") for blk in taps.conv_blocks for i in range(3)]
    assert len(convs) == 15 and all(c.impl == "pallas_taps" and c.kernel.shape[0] == 3 for c in convs)
    assert taps.conv_final1.kernel.shape[0] == 1  # 1x1 convs stay the flat matmul
    y = taps.conv0.conv1(torch.randn(1, 8, 16, requires_grad=True))
    assert y.grad_fn.next_functions[0][0].name() == "PallasTapConvBackward"
    with pytest.raises(ValueError, match="conv_impl"):
        BrainEncoder.from_config(load_config(None, ["tpu.conv_impl=fft"]), loc, num_subjects=S)
    assert BrainEncoder.from_config(load_config(None, ["D1=16", "D2=16", "K=4", "tpu.remat=true"]), loc,
                                    num_subjects=S).remat


# -- loss and classifier ------------------------------------------------------------


def _emb(seed, b=6, f=5, t=4):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(b, f, t)).astype(np.float32)
    return Y, (0.3 * Y + rng.normal(size=(b, f, t))).astype(np.float32)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_clip_loss_matches_jax(reduction):
    """f32: logits and loss at rtol 1e-5 / atol 1e-5."""
    Y, Z = _emb(0)
    temp = np.float32(1.3)
    jl, jloss = j_clip_loss(jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(temp), reduction, return_logits=True)
    tl, tloss = clip_loss(torch.from_numpy(Y), torch.from_numpy(Z), torch.tensor(temp), reduction, return_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5, atol=1e-5)


def test_clip_logits_f32_audio_against_bf16_brain():
    """The flagship mix: Y f32, Z bf16. JAX promotes the product to f32;
    the port casts explicitly. Both normalize Z in bf16, so they agree to
    f32 rounding (rtol 1e-5 / atol 1e-5); f32 logits come out."""
    Y, Z = _emb(1)
    Zb = jnp.asarray(Z, jnp.bfloat16)
    want = np.asarray(j_clip_logits(jnp.asarray(Y), Zb, jnp.asarray(0.5, jnp.float32)))
    got = clip_logits(torch.from_numpy(Y), torch.from_numpy(Z).bfloat16(), torch.tensor(0.5))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    both = clip_logits(torch.from_numpy(Y).bfloat16(), torch.from_numpy(Z).bfloat16(), torch.tensor(0.5))
    want16 = np.asarray(j_clip_logits(jnp.asarray(Y, jnp.bfloat16), Zb, jnp.asarray(0.5, jnp.float32)))
    np.testing.assert_allclose(both.numpy(), want16, rtol=1e-5, atol=1e-5)


def test_clip_module_and_helpers():
    Y, Z = _emb(2)
    m = CLIPLoss()
    assert m.temp.shape == (1,) and float(m.temp.detach()[0]) == pytest.approx(5.1)
    np.testing.assert_allclose(float(m(torch.from_numpy(Y), torch.from_numpy(Z)).detach()),
                               float(j_clip_loss(jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(5.1))), rtol=1e-5)
    with pytest.raises(ValueError, match="greater than 1"):
        clip_loss(torch.zeros(1, 3), torch.zeros(1, 3), torch.tensor(0.0))
    x = np.array([-30.0, 0.0, 5.0, 20.0], np.float32)
    np.testing.assert_allclose(clamped_exp(torch.from_numpy(x)).numpy(), np.asarray(j_clamped_exp(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(clamped_log(torch.from_numpy(np.abs(x))).numpy(),
                               np.asarray(j_clamped_log(jnp.asarray(np.abs(x)))), rtol=1e-6)
    np.testing.assert_allclose(float(mse_loss(torch.from_numpy(Y), torch.from_numpy(Z))),
                               float(j_mse_loss(jnp.asarray(Y), jnp.asarray(Z))), rtol=1e-6)


def test_classifier_functions_match_jax():
    """Similarity at rtol 1e-5 / atol 1e-6; accuracies (counts over 20 rows,
    averaged in f32 in another order) at rtol 1e-6, i.e. the same counts."""
    Y, Z = _emb(3, b=20)
    sim = cosine_similarity_matrix(torch.from_numpy(Z), torch.from_numpy(Y))
    jsim = jcls.cosine_similarity_matrix(jnp.asarray(Z), jnp.asarray(Y))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=1e-5, atol=1e-6)
    for ks in ((1, 10), (1, 5, 19)):
        got = retrieval_accuracy_from_similarity(sim, ks)
        want = jcls.retrieval_accuracy_from_similarity(jsim, ks)
        np.testing.assert_allclose([float(a) for a in got], [float(b) for b in want], rtol=1e-6)
    want = [float(v) for v in jcls.retrieval_metrics(jnp.asarray(Z), jnp.asarray(Y))]
    got = [float(v) for v in retrieval_metrics(torch.from_numpy(Z), torch.from_numpy(Y))]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got = Classifier()(torch.from_numpy(Z), torch.from_numpy(Y))
    np.testing.assert_allclose(got, jcls.Classifier()(jnp.asarray(Z), jnp.asarray(Y)), rtol=1e-6)
    assert 0 < want[1] < 1
