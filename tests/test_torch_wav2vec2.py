"""The port's wav2vec2 embedder against the JAX package's flax module on the
same params (through ``params_bridge.load_flax_wav2vec2``), against HF
``transformers`` through the port's state_dict loader, the safetensors
reader bitwise against JAX's, ``load_wav2vec_model`` from local files only,
and ``embed_waveform`` against JAX's. Tolerance rtol 1e-4, atol 1e-5 (f32
on both sides, sums in another order); the full-scale xlsr-53 parity runs
in the slow tier."""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.models import wav2vec2 as jw  # noqa: E402
from speech_decoding_tpu.models import wav2vec2_safetensors as jst  # noqa: E402
from speech_decoding_tpu.models import wav2vec_util as jutil  # noqa: E402
from speech_decoding_tpu_torch.models import wav2vec2 as pw  # noqa: E402
from speech_decoding_tpu_torch.models import wav2vec2_safetensors as pst  # noqa: E402
from speech_decoding_tpu_torch.models import wav2vec_util as putil  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import load_flax_wav2vec2  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jw.Wav2Vec2Config.tiny(), **kw)
    return jcfg, pw.Wav2Vec2Config(**dataclasses.asdict(jcfg))


def _flax_pair(seed=0, **kw):
    """A flax model with non-trivial params (init plus noise, so LayerNorm
    scales and biases are not 1 and 0) and the port's module on them."""
    jcfg, pcfg = _cfgs(**kw)
    model = jw.Wav2Vec2Model(jcfg)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 800)))
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), v)
    port = load_flax_wav2vec2(pw.Wav2Vec2Model(pcfg), v).eval()
    return jcfg, model, v, port


VARIANTS = {
    "layer_preln_even": dict(),
    "group_postln_even": dict(feat_extract_norm="group", do_stable_layer_norm=False),
    "layer_preln_odd": dict(num_conv_pos_embeddings=15),
    "group_postln_odd": dict(feat_extract_norm="group", do_stable_layer_norm=False, num_conv_pos_embeddings=15),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_module_matches_flax(variant):
    """Hidden states, last4_mean and features of the port's module against
    the flax module on the same params: 'layer' and 'group' extractor norms,
    pre- and post-LN layers, even and odd positional kernels."""
    jcfg, model, v, port = _flax_pair(**VARIANTS[variant])
    x = np.random.default_rng(1).normal(size=(2, 1600)).astype(np.float32)
    last, hidden = model.apply(v, jnp.asarray(x), output_hidden_states=True)
    with torch.no_grad():
        plast, phidden = port(torch.from_numpy(x), output_hidden_states=True)
    _close(plast, last)
    assert len(phidden) == len(hidden) == jcfg.num_hidden_layers + 1
    for p, j in zip(phidden, hidden):
        _close(p, j)

    jf = jutil.FrozenWav2Vec2(jcfg, jax.tree.map(jnp.asarray, v))
    pf = putil.FrozenWav2Vec2(port, device="cpu")
    _close(pf.last4_mean(x), jf.last4_mean(jnp.asarray(x)))
    _close(pf.features(x), jf.features(jnp.asarray(x)))
    _close(pw.extract_features(port, torch.from_numpy(x)), jw.extract_features(v, jcfg, jnp.asarray(x)))


def _hf(cfg, seed=0):
    hf_cfg = transformers.Wav2Vec2Config(
        conv_dim=list(cfg.conv_dim), conv_stride=list(cfg.conv_stride), conv_kernel=list(cfg.conv_kernel),
        conv_bias=cfg.conv_bias, feat_extract_norm=cfg.feat_extract_norm, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size, num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        do_stable_layer_norm=cfg.do_stable_layer_norm, hidden_act="gelu", hidden_dropout=0.0,
        activation_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        apply_spec_augment=False,
    )
    torch.manual_seed(seed)
    return transformers.Wav2Vec2Model(hf_cfg).eval()


def _legacy_weight_norm(sd):
    """The same state_dict with the positional conv's weight norm under the
    legacy names (weight_g/weight_v)."""
    pre = "encoder.pos_conv_embed.conv."
    out = dict(sd)
    out[pre + "weight_g"] = out.pop(pre + "parametrizations.weight.original0")
    out[pre + "weight_v"] = out.pop(pre + "parametrizations.weight.original1")
    return out


@pytest.mark.parametrize("stable,legacy", [(True, False), (False, False), (True, True)])
def test_hf_state_dict_loader_matches_transformers(stable, legacy):
    _, cfg = _cfgs(do_stable_layer_norm=stable, feat_extract_norm="layer" if stable else "group")
    hf = _hf(cfg)
    sd = hf.state_dict()
    assert "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd
    if legacy:
        sd = _legacy_weight_norm(sd)
    port = pw.model_from_torch(sd, cfg).eval()
    x = np.random.default_rng(2).normal(size=(2, 1600)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(x), output_hidden_states=True)
        last, hidden = port(torch.from_numpy(x), output_hidden_states=True)
    _close(last, ref.last_hidden_state)
    assert len(hidden) == len(ref.hidden_states)
    for p, r in zip(hidden, ref.hidden_states):
        _close(p, r)
    # the tree equals the JAX package's mapping of the same state_dict
    want = jw.params_from_torch(sd, jw.Wav2Vec2Config(**dataclasses.asdict(cfg)))
    got = pw.params_from_torch(sd, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_params_from_torch_raises_without_pos_conv():
    _, cfg = _cfgs()
    sd = {k: v for k, v in _hf(cfg).state_dict().items() if "pos_conv_embed.conv.parametrizations" not in k}
    with pytest.raises(KeyError, match="pos_conv"):
        pw.params_from_torch(sd, cfg)


def _saved(tmp_path, dtype=torch.float32, prefix=""):
    from safetensors.torch import save_file

    _, cfg = _cfgs()
    hf = _hf(cfg, seed=3)
    path = str(tmp_path / "model.safetensors")
    save_file({prefix + k: v.contiguous().to(dtype) for k, v in hf.state_dict().items()}, path)
    return hf, cfg, path


@pytest.mark.parametrize("dtype,prefix", [(torch.float32, ""), (torch.bfloat16, ""), (torch.float32, "wav2vec2.")])
def test_safetensors_reader_bitwise(tmp_path, dtype, prefix):
    _, _, path = _saved(tmp_path, dtype, prefix)
    got, want = pst.read_safetensors(path), jst.read_safetensors(path)
    assert sorted(got) == sorted(want) and not any(k.startswith("wav2vec2.") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_safetensors_config_and_loader(tmp_path):
    """infer_config and config_from_json equal JAX's; the loaded module holds
    the JAX loader's params bit for bit, in the dtype asked for."""
    hf, cfg, path = _saved(tmp_path)
    tensors = pst.read_safetensors(path)
    assert dataclasses.asdict(pst.infer_config(tensors, num_attention_heads=4)) == \
        dataclasses.asdict(jst.infer_config(tensors, num_attention_heads=4))
    hc = hf.config.to_dict()
    assert dataclasses.asdict(pst.config_from_json(hc)) == dataclasses.asdict(jst.config_from_json(hc))
    model = pst.load_safetensors_params(path, cfg)
    variables, jcfg = jst.load_safetensors_params(path, jw.Wav2Vec2Config(**dataclasses.asdict(cfg)))
    assert model.cfg == cfg and dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert len(flat) == len(sd)
    for path_, leaf in flat:
        name = ".".join(p.key for p in path_)
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(leaf))
    bf = pst.load_safetensors_params(path, cfg, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_load_wav2vec_model_from_local_files(tmp_path):
    """A checkpoint saved in tmp_path loads three ways (safetensors file,
    safetensors directory, transformers from a local directory without
    safetensors) and embeds as the HF model does."""
    _, cfg = _cfgs()
    hf = _hf(cfg, seed=11)
    st_dir = str(tmp_path / "st")
    hf.save_pretrained(st_dir)
    bin_dir = str(tmp_path / "bin")
    hf.save_pretrained(bin_dir, safe_serialization=False)
    assert os.path.exists(os.path.join(st_dir, "model.safetensors"))
    assert not os.path.exists(os.path.join(bin_dir, "model.safetensors"))
    wav = np.random.default_rng(9).normal(size=(1, 1600)).astype(np.float32)
    with torch.no_grad():
        ref = torch.stack(hf(torch.from_numpy(wav), output_hidden_states=True).hidden_states[-4:]).mean(0)
    for where in (os.path.join(st_dir, "model.safetensors"), st_dir, bin_dir):
        frozen = putil.load_wav2vec_model(where, device="cpu")
        assert frozen.device.type == "cpu" and frozen.cfg == cfg
        _close(frozen.last4_mean(wav), ref)


def test_load_wav2vec_model_raises_when_nothing_is_local():
    with pytest.raises(RuntimeError, match="local checkpoint"):
        putil.load_wav2vec_model("nonexistent/model-name-xyz", device="cpu")


@pytest.mark.parametrize("last4layers,n", [(True, 8000), (True, 8003), (False, 4000)])
def test_embed_waveform_matches_jax(last4layers, n):
    """The reference's 10-chunk split (two chunk lengths when n % 10 != 0,
    batched as two forwards) and the feature path, against JAX's."""
    jcfg, _, v, port = _flax_pair(seed=4)
    wav = np.random.default_rng(5).normal(size=n).astype(np.float32)
    got = putil.embed_waveform(putil.FrozenWav2Vec2(port, device="cpu"), wav, last4layers=last4layers)
    want = jutil.embed_waveform(jutil.FrozenWav2Vec2(jcfg, jax.tree.map(jnp.asarray, v)), wav,
                                last4layers=last4layers)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _close(got, want)


def test_frozen_embedder_device_policy():
    """The embedder defaults to ``cuda`` and raises without a card; it keeps
    no gradients and runs in the dtype asked for."""
    _, _, _, port = _flax_pair(seed=6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            putil.FrozenWav2Vec2(port)
    frozen = putil.FrozenWav2Vec2(port, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in frozen.model.parameters())
    out = frozen.last4_mean(np.zeros((1, 1600), np.float32))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.slow  # the 315M-parameter model on the CPU
def test_full_scale_xlsr53_matches_transformers():
    """The full xlsr-53 architecture (random weights) through the port's
    loader against transformers on 1 s of audio, at the JAX slow test's
    tolerance (2e-4 of the largest entry)."""
    cfg = pw.Wav2Vec2Config()
    hf = _hf(cfg)
    assert sum(p.numel() for p in hf.parameters()) > 3e8
    port = pw.model_from_torch(hf.state_dict(), cfg).eval()
    wav = np.random.default_rng(3).normal(size=(1, 16000)).astype(np.float32) * 0.1
    with torch.no_grad():
        ref = hf(torch.from_numpy(wav), output_hidden_states=True)
        last, hidden = port(torch.from_numpy(wav), output_hidden_states=True)
    for got, want in ((last, ref.last_hidden_state),
                      (torch.stack(hidden[-4:]).mean(0), torch.stack(ref.hidden_states[-4:]).mean(0))):
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale, atol=2e-4)


def test_bench_wav2vec_tool_runs_at_a_small_size():
    from speech_decoding_tpu_torch.tools import bench_wav2vec

    _, cfg = _cfgs()
    out = bench_wav2vec.measure_embed_rate(batch=2, dtype="float32", warmup=1, rounds=1, reps=1,
                                           device="cpu", cfg=cfg)
    assert out["audio_s_per_s"] > 0 and out["device"] == "cpu" and out["clock"] == "host"
    assert out["hidden"] == cfg.hidden_size and out["frames"] == 799  # 16000 samples, strides 5, 2, 2
