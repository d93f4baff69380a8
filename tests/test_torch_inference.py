"""The port's SpeechDecoder against the JAX SpeechDecoder: decode (fused and
module encode, f32 and int8 bank), decode_stream, the bank checks, the
device policy and the serve CLI's decoder build."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.inference import SpeechDecoder as JaxDecoder  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu_torch.inference import (  # noqa: E402
    SpeechDecoder,
    quantize_rows_int8,
    retrieve_topk,
    retrieve_topk_int8,
)
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import load_flax  # noqa: E402

torch.set_num_threads(1)

B, C, T, D, F, K, S, N = 4, 208, 40, 16, 16, 4, 2, 24
KW = dict(num_subjects=S, D1=D, D2=D, F=F, K=K)


@pytest.fixture(scope="module")
def model():
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    enc = JaxEncoder(loc=loc, **KW)
    v = enc.init(jax.random.PRNGKey(1), jnp.zeros((2, C, T)), jnp.zeros((2,), jnp.int32))
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else 0.2 * rng.normal(size=a.shape)).astype(np.float32),
        v["batch_stats"],
    )
    params = jax.tree.map(np.asarray, v["params"])
    bank = rng.normal(size=(N, F, T)).astype(np.float32)
    return loc, params, stats, bank


def _jax_decoder(model, fused, channels_last=False):
    loc, params, stats, _ = model
    enc = JaxEncoder(loc=loc, channels_last_io=channels_last, **KW)
    return JaxDecoder(enc, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                      use_fused_blocks=fused)


def _port_decoder(model, fused, channels_last=False):
    loc, params, stats, _ = model
    enc = load_flax(BrainEncoder(loc=loc, channels_last_io=channels_last, **KW), params, stats)
    return SpeechDecoder(enc, use_fused_blocks=fused, device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, C, T)).astype(np.float32), np.array([0, 1, 1, 0], np.int32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("store", ["float32", "int8"])
def test_decode_matches_jax(model, fused, store):
    bank = model[3]
    X, ids = _batch(0)
    jd = _jax_decoder(model, fused)
    jd.set_bank(jnp.asarray(bank), store_dtype=store)
    td = _port_decoder(model, fused)
    td.set_bank(bank, store_dtype=store)
    np.testing.assert_allclose(td.encode(X, ids).numpy(), np.asarray(jd.encode(X, ids)), rtol=1e-4, atol=1e-6)
    s_want, i_want = jd.decode(X, ids, k=5)
    s_got, i_got = td.decode(X, ids, k=5)
    assert i_got.dtype == np.int32 and s_got.dtype == np.float32
    np.testing.assert_array_equal(i_got, i_want)
    np.testing.assert_allclose(s_got, s_want, rtol=0, atol=1e-5)


def test_decode_stream_matches_jax(model):
    """Overlapping windows, a zero-padded final batch, both layouts."""
    rng = np.random.default_rng(4)
    rec = rng.normal(size=(C, 150)).astype(np.float32)
    bank = model[3]
    jd = _jax_decoder(model, False)
    jd.set_bank(jnp.asarray(bank))
    want = jd.decode_stream(rec, 1, T, hop=17, k=3, batch_size=3)
    for cl in (False, True):
        td = _port_decoder(model, True, channels_last=cl)
        td.set_bank(bank)
        got = td.decode_stream(rec.T if cl else rec, 1, T, hop=17, k=3, batch_size=3)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)


def test_channels_last_bank_alignment_and_check(model):
    """A channels-last decoder transposes the (N, F, T) bank to match its
    (B, T, F) output; an (N, T, F) bank raises with the swapaxes hint."""
    X, ids = _batch(2)
    ref = _port_decoder(model, False)
    ref.set_bank(model[3])
    cl = _port_decoder(model, False, channels_last=True)
    cl.set_bank(model[3])
    s_ref, i_ref = ref.decode(X, ids, k=3)
    s_cl, i_cl = cl.decode(np.swapaxes(X, -1, -2), ids, k=3)
    np.testing.assert_array_equal(i_cl, i_ref)
    np.testing.assert_allclose(s_cl, s_ref, atol=1e-5)
    Z = cl.encode(np.swapaxes(X, -1, -2), ids)  # (B, T, F)
    with pytest.raises(ValueError, match="swapaxes"):
        cl.set_bank(Z)
    with pytest.raises(ValueError, match="feature dim"):
        cl.set_bank(np.zeros((3, F + 1, T), np.float32))
    with pytest.raises(ValueError, match="store_dtype"):
        cl.set_bank(model[3], store_dtype="float16")


def test_self_bank_retrieves_itself(model):
    X, ids = _batch(3)
    td = _port_decoder(model, True)
    td.set_bank(td.encode(X, ids))
    s, i = td.decode(X, ids, k=1)
    np.testing.assert_allclose(s[:, 0], 1.0, atol=1e-5)
    assert td.bank_size == B


def test_retrieval_ops_match_jax():
    from speech_decoding_tpu.inference import quantize_rows_int8 as jq
    from speech_decoding_tpu.inference import retrieve_topk as jr
    from speech_decoding_tpu.inference import retrieve_topk_int8 as jr8

    rng = np.random.default_rng(7)
    Z = rng.normal(size=(3, 5, 11)).astype(np.float32)
    bank = rng.normal(size=(6, 55)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    s, i = retrieve_topk(torch.from_numpy(Z), torch.from_numpy(bank), k=10)  # k clamps to N=6
    js, ji = jr(jnp.asarray(Z), jnp.asarray(bank), k=10)
    assert s.shape == (3, 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    q, scale = quantize_rows_int8(torch.from_numpy(bank))
    jqq, jscale = jq(jnp.asarray(bank))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)
    s8, i8 = retrieve_topk_int8(torch.from_numpy(Z), q, scale, k=4)
    js8, ji8 = jr8(jnp.asarray(Z), jqq, jscale, k=4)
    np.testing.assert_array_equal(i8.numpy(), np.asarray(ji8))
    np.testing.assert_allclose(s8.numpy(), np.asarray(js8), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_subject_id_out_of_range_raises(model, fused):
    td = _port_decoder(model, fused)
    X, _ = _batch(5)
    with pytest.raises(ValueError, match="subject ids"):
        td.encode(X, np.array([0, 1, S, 0], np.int32))


def test_default_device_is_cuda_and_raises_without_gpu(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loc, params, stats, _ = model
    enc = load_flax(BrainEncoder(loc=loc, **KW), params, stats)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeechDecoder(enc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeechDecoder(enc, device="cuda")
    assert SpeechDecoder(enc, device="cpu").use_fused_blocks is False  # fused is the default on the card


def test_serve_cli_builds_decoder_from_torch_checkpoint(tmp_path, model):
    """serve.build_decoder(torch_checkpoint=...) == loading the same weights
    through the JAX package's importer."""
    from speech_decoding_tpu.models.torch_port import brain_encoder_from_torch as jax_import
    from speech_decoding_tpu_torch import serve
    from speech_decoding_tpu_torch.config import load_config
    from test_torch_models import _reference_state_dict

    sd = _reference_state_dict(np.random.default_rng(9), S_=2, D1=12, D2=10, F_=8, K_=2)
    path = tmp_path / "model_last.pt"
    torch.save(sd, path)
    args = load_config(None, [f"torch_checkpoint={path}", "dataset=Brennan2018",
                              "tpu.compute_dtype=float32"])
    args.root_dir = str(tmp_path)
    dec = serve.build_decoder(args, device="cpu")
    loc = ch_locations_2d("Brennan2018", cache=False)
    params, stats, dims = jax_import(sd)
    jenc = JaxEncoder(num_subjects=2, loc=loc, D1=12, D2=10, F=8, K=2)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 60, 20)).astype(np.float32)
    ids = np.array([1, 0], np.int32)
    want = np.asarray(jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(X),
                                 jnp.asarray(ids), train=False))
    np.testing.assert_allclose(dec.encode(X, ids).numpy(), want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="torch_checkpoint"):
        serve.build_decoder(load_config(None, []), device="cpu")
    bank_path = tmp_path / "bank.npz"
    np.savez(bank_path, bank=np.zeros((2, 8, 20), np.float32))
    assert serve.load_bank(str(bank_path)).shape == (2, 8, 20)


def test_serve_cli_torch_checkpoint_is_f32_under_the_default_config(tmp_path, model):
    """With the default config (``tpu.compute_dtype`` bfloat16, no override)
    a ``torch_checkpoint=`` encoder still computes in f32, as
    ``tools/serve.py`` builds the JAX encoder: every parameter is f32 and
    ``encode`` matches the JAX encoder at rtol 1e-4, atol 1e-5."""
    from speech_decoding_tpu.models.torch_port import brain_encoder_from_torch as jax_import
    from speech_decoding_tpu_torch import serve
    from speech_decoding_tpu_torch.config import load_config
    from test_torch_models import _reference_state_dict

    sd = _reference_state_dict(np.random.default_rng(11), S_=2, D1=12, D2=10, F_=8, K_=2)
    path = tmp_path / "model_last.pt"
    torch.save(sd, path)
    args = load_config(None, [f"torch_checkpoint={path}", "dataset=Brennan2018"])
    assert str(args.select("tpu.compute_dtype")) == "bfloat16"
    args.root_dir = str(tmp_path)
    dec = serve.build_decoder(args, device="cpu")
    assert dec.encoder.compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in dec.encoder.parameters())
    loc = ch_locations_2d("Brennan2018", cache=False)
    params, stats, _ = jax_import(sd)
    jenc = JaxEncoder(num_subjects=2, loc=loc, D1=12, D2=10, F=8, K=2)
    X = np.random.default_rng(1).normal(size=(3, 60, 20)).astype(np.float32)
    ids = np.array([0, 1, 1], np.int32)
    want = np.asarray(jenc.apply({"params": params, "batch_stats": stats}, jnp.asarray(X),
                                 jnp.asarray(ids), train=False))
    np.testing.assert_allclose(dec.encode(X, ids).numpy(), want, rtol=1e-4, atol=1e-5)
