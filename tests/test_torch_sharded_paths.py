"""The port's memory-scaling paths across ranks, f32 on the CPU: gloo ranks
spawned as fresh processes (``parallel.multihost.spawn_ranks``) at W = 1, 2
and 4, each passing its block of the same inputs (made with numpy from
fixed seeds in every process), held against the port in one process and
against JAX on the conftest's 8-device mesh:

  * the data-parallel train step with remat (module convs and
    ``pallas_taps``): summed gradients, loss and running statistics equal
    to the same group step without remat (≤ 1e-6), and to the one-process
    step on the global batch (as ``tests/test_torch_parallel.py`` holds
    it); the collectives a step makes counted on every rank, equal with
    and without remat (the recomputation reuses the forward's BatchNorm
    sums);
  * ``SpeechDecoder.set_bank(..., group=)`` with f32 and int8 banks: each
    rank holds only its row block; ``decode`` (k within a block and k
    larger than one), and ``decode_stream`` return the one-process
    decoder's ids and JAX's ``set_bank(mesh=)`` ids, scores within 1e-5
    (f32) and 1e-6 (int8), identical on every rank; a bank whose N does
    not divide by the ranks raises, as JAX's row sharding does;
  * ``parallel.preproc_sharded``: the time-sharded band-pass (its halo
    by one all-gather), the channel-sharded FFT resample and band-pass + resample
    chain, at JAX's shapes and tolerances (``tests/test_sharding.py``),
    against the port's one-process DSP and JAX's sharded functions; a block
    no longer than the filter's half-length, or blocks of unequal length,
    raise on every rank.

One spawn a world size, all in one module fixture; the ranks import no JAX."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.inference import SpeechDecoder  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, dropout_mask_at  # noqa: E402
from speech_decoding_tpu_torch.ops.fir import bandpass_filter, design_bandpass_fir  # noqa: E402
from speech_decoding_tpu_torch.ops.resample import fft_resample  # noqa: E402
from speech_decoding_tpu_torch.parallel import data_group, shard_batch  # noqa: E402
from speech_decoding_tpu_torch.parallel.collectives import calls  # noqa: E402
from speech_decoding_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402
from speech_decoding_tpu_torch.parallel.preproc_sharded import (  # noqa: E402
    bandpass_filter_sharded,
    bandpass_resample_sharded,
    fft_resample_sharded,
)
from speech_decoding_tpu_torch.training import create_train_state, make_train_step  # noqa: E402

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
# the train step (tests/test_torch_parallel.py's widths)
S, D1, D2, F, K, C, T, B_STEP, LR = 2, 16, 24, 32, 4, 208, 48, 16, 1e-3
# the decoder and bank (tests/test_sharding.py's)
DEC = dict(num_subjects=2, D1=16, D2=16, F=16, K=4)
B_DEC, T_DEC, N_BANK, K_WIDE = 4, 30, 64, 40
STREAM_LEN, HOP = 150, 20
HALO = (len(design_bandpass_fir(250.0, 2.0, 40.0)) - 1) // 2  # 206: the band-pass cases' filter half-length


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _loc():
    return ch_locations_2d("Gwilliams2022", cache=False)


def _step_batch():
    rng = np.random.default_rng(4)
    return {"X": (rng.normal(size=(B_STEP, C, T)) * 2).astype(np.float32),
            "Y": rng.normal(size=(B_STEP, F, T)).astype(np.float32),
            "subject_idxs": rng.integers(0, S, B_STEP).astype(np.int32)}


def _step_encoder(remat, conv_impl):
    return BrainEncoder(num_subjects=S, loc=_loc(), D1=D1, D2=D2, F=F, K=K, remat=remat, conv_impl=conv_impl,
                        generator=torch.Generator().manual_seed(0))


def _dec_inputs():
    rng = np.random.default_rng(8)
    return {"X": rng.normal(size=(B_DEC, C, T_DEC)).astype(np.float32),
            "sidx": rng.integers(0, 2, B_DEC).astype(np.int32),
            "bank": rng.normal(size=(N_BANK, DEC["F"], T_DEC)).astype(np.float32),
            "recording": rng.normal(size=(C, STREAM_LEN)).astype(np.float32)}


def _preproc_inputs():
    rng = np.random.default_rng(5)
    return {"bandpass": rng.normal(size=(3, 4000)).astype(np.float32),  # 250 Hz: half-length 412
            "resample": rng.normal(size=(16, 3000)).astype(np.float32),
            "chain": rng.normal(size=(8, 5000)).astype(np.float32)}


# -- what each rank (or one process, group=None) computes -----------------------------------------


def _step_run(group, remat, conv_impl):
    """One train step from the seed-0 encoder on the global batch (the
    rank's block under a group): loss, top-k, the (summed) gradients, the
    running statistics and the collectives made, by kind."""
    st = create_train_state(_step_encoder(remat, conv_impl), lr=LR, device="cpu", group=group)
    b = {k: _t(v) for k, v in _step_batch().items()}
    before = dict(calls)
    st, m = make_train_step(group=group)(st, b if group is None else shard_batch(b, group),
                                         drop_mask=dropout_mask_at(_loc(), 7, 0.1))
    grads = {n: _np(p.grad) for n, p in st.encoder.named_parameters()}
    grads["clip.temp"] = _np(st.clip.temp.grad)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
            "stats": {n: _np(v) for n, v in st.encoder.named_buffers() if n.endswith(("mean", "var"))},
            "collectives": {k: v - before.get(k, 0) for k, v in calls.items() if v - before.get(k, 0)}}


def _decoder(sd):
    enc = BrainEncoder(loc=_loc(), **DEC)
    enc.load_state_dict({k: _t(v) for k, v in sd.items()})
    return SpeechDecoder(enc, device="cpu")


def _bank_run(group, sd):
    dec, inp = _decoder(sd), _dec_inputs()
    out = {}
    for dtype in ("float32", "int8"):
        dec.set_bank(inp["bank"], dtype, group=group)
        rows = dec._bank_norm if dtype == "float32" else dec._bank_q
        out[dtype] = {"rows": int(rows.shape[0]), "bank_size": dec.bank_size,
                      "scale_rows": None if dec._bank_scale is None else int(dec._bank_scale.shape[0]),
                      "decode": dec.decode(inp["X"], inp["sidx"], k=5),
                      "decode_wide": dec.decode(inp["X"], inp["sidx"], k=K_WIDE),
                      "stream": dec.decode_stream(inp["recording"], 1, T_DEC, hop=HOP, k=5, batch_size=4)}
    if group is not None:
        try:
            dec.set_bank(inp["bank"][: N_BANK - 1], group=group)
            out["uneven"] = "accepted"
        except ValueError as e:
            out["uneven"] = str(e)
    return out


def _preproc_run(group):
    x = _preproc_inputs()
    tb, cr, cc = group.block(4000), group.block(16), group.block(8)
    out = {"bandpass": _np(bandpass_filter_sharded(x["bandpass"][:, tb], 250.0, 2.0, 40.0, group)),
           "resample": _np(fft_resample_sharded(x["resample"][cr], 120.0, 1000.0, group)),
           "chain": _np(bandpass_resample_sharded(x["chain"][cc], 500.0, 1.0, 60.0, 120.0, group))}
    refusals = {"short": x["bandpass"][:, :HALO], "unequal": x["bandpass"][:, : 1000 + group.rank]}
    for name, block in refusals.items():
        try:
            bandpass_filter_sharded(block, 250.0, 2.0, 40.0, group)
            out[name] = "accepted"
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_all(sd_dec):
    group = data_group("cpu")
    out = {"rank": group.rank, "preproc": _preproc_run(group), "bank": _bank_run(group, sd_dec)}
    out["steps"] = {(impl, remat): _step_run(group, remat, impl)
                    for impl in ("gemm", "pallas_taps") for remat in (False, True)}
    return out


# -- the references -------------------------------------------------------------------------------


def _jax_decoder_init():
    """JAX's decoder encoder, its parameters and (random) BN statistics, and
    the same weights in the port's layout."""
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.models import BrainEncoder as JaxEncoder
    from speech_decoding_tpu_torch.models.params_bridge import load_flax

    enc = JaxEncoder(loc=_loc(), **DEC)
    v = enc.init(jax.random.PRNGKey(1), jnp.zeros((2, C, T_DEC)), jnp.zeros((2,), jnp.int32))
    rng = np.random.default_rng(9)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else 0.2 * rng.normal(size=a.shape)).astype(np.float32), v["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    port = load_flax(BrainEncoder(loc=_loc(), **DEC), params, stats)
    return enc, params, stats, {k: _np(t) for k, t in port.state_dict().items()}


def _jax_refs(enc, params, stats):
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.inference import SpeechDecoder as JaxDecoder
    from speech_decoding_tpu.parallel import make_mesh
    from speech_decoding_tpu.parallel.preproc_sharded import (
        bandpass_filter_sharded as j_bandpass,
        bandpass_resample_sharded as j_chain,
        fft_resample_sharded as j_resample,
    )

    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    x = _preproc_inputs()
    ref = {"preproc": {"bandpass": np.asarray(j_bandpass(jnp.asarray(x["bandpass"]), 250.0, 2.0, 40.0, mesh)),
                       "resample": np.asarray(j_resample(jnp.asarray(x["resample"]), 120.0, 1000.0, mesh)),
                       "chain": np.asarray(j_chain(jnp.asarray(x["chain"]), 500.0, 1.0, 60.0, 120.0, mesh))}}
    dec = JaxDecoder(enc, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats), use_fused_blocks=False)
    inp = _dec_inputs()
    ref["bank"] = {}
    for dtype in ("float32", "int8"):
        dec.set_bank(jnp.asarray(inp["bank"]), mesh=mesh, store_dtype=dtype)
        ref["bank"][dtype] = {"decode": dec.decode(inp["X"], inp["sidx"], k=5),
                              "decode_wide": dec.decode(inp["X"], inp["sidx"], k=K_WIDE),
                              "stream": dec.decode_stream(inp["recording"], 1, T_DEC, hop=HOP, k=5, batch_size=4)}
    try:
        dec.set_bank(jnp.asarray(inp["bank"][: N_BANK - 1]), mesh=mesh)
        ref["bank"]["uneven"] = "accepted"
    except ValueError as e:
        ref["bank"]["uneven"] = str(e)
    return ref


@pytest.fixture(scope="module")
def runs():
    """The W = 1, 2 and 4 ranks (spawned together once the decoder weights
    exist, running while JAX and the one process compute their
    references), JAX's references and the one-process runs."""
    from concurrent.futures import ThreadPoolExecutor

    enc, params, stats, sd = _jax_decoder_init()
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        ranks = {w: ex.submit(spawn_ranks, _rank_all, w, (sd,), torch_threads=1, timeout=300) for w in WORLDS}
        x = _preproc_inputs()
        one = {"bank": _bank_run(None, sd),
               "steps": {(impl, False): _step_run(None, False, impl) for impl in ("gemm", "pallas_taps")},
               "preproc": {"bandpass": _np(bandpass_filter(_t(x["bandpass"]), 250.0, 2.0, 40.0)),
                           "resample": _np(fft_resample(_t(x["resample"]), up=120.0, down=1000.0)),
                           "chain": _np(fft_resample(bandpass_filter(_t(x["chain"]), 500.0, 1.0, 60.0),
                                                     up=120.0, down=500.0))}}
        return {"jax": _jax_refs(enc, params, stats), "one": one, **{w: f.result() for w, f in ranks.items()}}


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()), err_msg=what)


# -- remat under a group ------------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("conv_impl", ["gemm", "pallas_taps"])
def test_remat_group_step_equals_plain_group_step(runs, world, conv_impl):
    """Summed gradients, loss, top-k and running statistics of the remat
    group step against the plain group step on every rank: within 1e-6."""
    for r in runs[world]:
        plain, remat = r["steps"][conv_impl, False], r["steps"][conv_impl, True]
        assert remat["metrics"] == plain["metrics"]
        for key in ("grads", "stats"):
            for name, want in plain[key].items():
                np.testing.assert_allclose(remat[key][name], want, rtol=0, atol=1e-6, err_msg=f"{key} {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_remat_group_step_makes_the_plain_steps_collectives(runs, world):
    """The recomputation makes no collective: a remat step's all-reduces
    and all-gathers equal the plain step's on every rank (28 a step: 20 BN
    sums, 7 in the CLIP loss and its top-k, 1 gradient all-reduce)."""
    counts = [r["steps"][impl, remat]["collectives"] for r in runs[world]
              for impl in ("gemm", "pallas_taps") for remat in (False, True)]
    assert all(c == counts[0] for c in counts), counts
    assert sum(counts[0].values()) == 28, counts[0]


@pytest.mark.parametrize("world", [2, 4])
def test_remat_group_step_matches_one_process(runs, world):
    """The remat group step on the ranks' blocks against the one-process
    plain step on the global batch (tests/test_torch_parallel.py's bounds):
    loss at rtol 1e-5, top-k equal, gradients at 1e-4 of each tensor's
    largest entry (the conv0/conv1 biases ahead of a batch-stat BN, zero in
    exact arithmetic, at 1e-5 of the model's largest gradient), running
    statistics at rtol 1e-5."""
    for impl in ("gemm", "pallas_taps"):
        ref = runs["one"]["steps"][impl, False]
        gmax = max(float(np.abs(g).max()) for g in ref["grads"].values())
        for r in runs[world]:
            got = r["steps"][impl, True]
            assert got["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"], rel=1e-5)
            assert [got["metrics"][k] for k in ("top1", "top10")] == [ref["metrics"][k] for k in ("top1", "top10")]
            for name, want in ref["grads"].items():
                zero = name.split(".")[-2:-1] in (["conv0"], ["conv1"]) and name.endswith("bias")
                atol = 1e-5 * gmax if zero else 1e-4 * float(np.abs(want).max())
                np.testing.assert_allclose(got["grads"][name], want, rtol=0, atol=atol, err_msg=f"{impl} {name}")
            for name, want in ref["stats"].items():
                np.testing.assert_allclose(got["stats"][name], want, rtol=1e-5, atol=1e-6, err_msg=name)


# -- the row-sharded serving bank ------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_bank_holds_only_the_ranks_rows(runs, world, dtype):
    for r in runs[world]:
        got = r["bank"][dtype]
        assert got["rows"] == N_BANK // world and got["bank_size"] == N_BANK
        assert got["scale_rows"] == (N_BANK // world if dtype == "int8" else None)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_bank_matches_one_process_and_jax(runs, world, dtype):
    """decode at k=5, at k=40 (more than a block's 32 or 16 rows) and
    decode_stream: ids equal to the one-process decoder's and to JAX's
    mesh-sharded bank's, scores within 1e-5 (f32) or 1e-6 (int8: the same
    quantized values, exact products), identical on every rank."""
    atol = 1e-5 if dtype == "float32" else 1e-6
    for call, k in (("decode", 5), ("decode_wide", K_WIDE), ("stream", 5)):
        one, jref = runs["one"]["bank"][dtype][call], runs["jax"]["bank"][dtype][call]
        first = runs[world][0]["bank"][dtype][call]
        assert first[1].shape[1] == k
        for r in runs[world]:
            got = r["bank"][dtype][call]
            for a, b in zip(got, first):
                np.testing.assert_array_equal(a, b, err_msg=call)  # every rank's answer is the same
            np.testing.assert_array_equal(got[1], one[1], err_msg=call)
            np.testing.assert_array_equal(got[1], np.asarray(jref[1]), err_msg=call)
            np.testing.assert_allclose(got[0], one[0], rtol=0, atol=atol, err_msg=call)
            np.testing.assert_allclose(got[0], np.asarray(jref[0]), rtol=0, atol=atol, err_msg=call)
            if call == "stream":
                np.testing.assert_array_equal(got[2], np.asarray(jref[2]))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bank_rows_must_divide_by_the_ranks(runs, world):
    """N=63 over W ranks raises on every rank, as JAX's set_bank(mesh=)
    raises for 63 rows over its 8 devices."""
    assert "accepted" != runs["jax"]["bank"]["uneven"]
    for r in runs[world]:
        assert "not divisible" in r["bank"]["uneven"], r["bank"]["uneven"]


# -- sharded preprocessing ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_bandpass(runs, world):
    """The ranks' blocks in order against the one-process band-pass and
    JAX's time-sharded one (rtol 2e-4, atol 2e-5, JAX's bounds); at W=1
    the halo is the recording's own reflect-limited pad on both sides."""
    got = np.concatenate([r["preproc"]["bandpass"] for r in runs[world]], axis=-1)
    np.testing.assert_allclose(got, runs["one"]["preproc"]["bandpass"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, runs["jax"]["preproc"]["bandpass"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_channel_sharded_resample(runs, world):
    """rtol 1e-5, atol 1e-6 (JAX's bounds): each rank runs the one-process
    resample on its channels."""
    got = np.concatenate([r["preproc"]["resample"] for r in runs[world]])
    np.testing.assert_allclose(got, runs["one"]["preproc"]["resample"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, runs["jax"]["preproc"]["resample"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_channel_sharded_bandpass_resample_chain(runs, world):
    got = np.concatenate([r["preproc"]["chain"] for r in runs[world]])
    assert got.shape == (8, 1200)
    np.testing.assert_allclose(got, runs["one"]["preproc"]["chain"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, runs["jax"]["preproc"]["chain"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_bandpass_refuses_short_or_unequal_blocks(runs, world):
    """A block of 206 samples (the filter's half-length at 250 Hz) raises on
    every rank, at W=1 too; blocks of unequal length raise on every rank."""
    assert HALO == 206
    for r in runs[world]:
        assert f"must exceed the filter half-length {HALO}" in r["preproc"]["short"]
        if world > 1:
            assert "same length" in r["preproc"]["unequal"]
        else:
            assert r["preproc"]["unequal"] == "accepted"
