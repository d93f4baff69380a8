"""The port's train and eval steps against the JAX package's, in f32 on the
CPU: a 10-step trajectory of ``make_train_step`` (use_pallas=True,
conv_impl="gemm_pdw", precomputed collate stats, channels-last), one Adam
step and MultiSteps against optax, the scan, forward-only and eval steps,
and the train-state bridge. The JAX Pallas kernels run in interpret mode, as
the JAX package's own tests run them on the CPU. Each port step gets the
drop mask that the JAX step draws (sown as ``intermediates/drop_mask``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu.models.loss import clip_loss as j_clip_loss  # noqa: E402
from speech_decoding_tpu.ops.scaling import window_scale_stats as j_window_scale_stats  # noqa: E402
from speech_decoding_tpu.training import state as jstate  # noqa: E402
from speech_decoding_tpu.training import steps as jsteps  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import flax_train_from_state, load_flax_train  # noqa: E402
from speech_decoding_tpu_torch.training import (  # noqa: E402
    create_train_state,
    make_chunked_eval,
    make_eval_step,
    make_train_forward_step,
    make_train_step,
    make_train_step_scan,
)
from speech_decoding_tpu_torch.training.state import MultiSteps, make_optimizer  # noqa: E402

torch.set_num_threads(1)

S, D1, D2, F, K, B, T, C = 3, 16, 24, 32, 4, 8, 48, 208
LR = 1e-3
STEPS = 10
COLLATE = {"baseline_len_samp": 10, "clamp_lim": 20.0, "clamp": True, "precomputed": True,
           "channels_last": True}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _batches(n, seed=0):
    """n channels-last batches with precomputed (JAX) scale stats, numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        X = (rng.normal(size=(B, T, C)) * 10 + 3).astype(np.float32)
        out.append({
            "X": X,
            "Y": rng.normal(size=(B, T, F)).astype(np.float32),
            "subject_idxs": rng.integers(0, S, B).astype(np.int32),
            "scale_stats": np.asarray(j_window_scale_stats(jnp.swapaxes(jnp.asarray(X), 1, 2))),
        })
    return out


def _jax_setup(accumulate_steps=1):
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    enc = JaxEncoder(num_subjects=S, loc=loc, D1=D1, D2=D2, F=F, K=K, use_pallas=True,
                     conv_impl="gemm_pdw", channels_last_io=True)
    b0 = _batches(1, seed=99)[0]
    state = jstate.create_train_state(enc, jax.random.PRNGKey(2), jnp.asarray(b0["X"]),
                                      jnp.asarray(b0["subject_idxs"]), lr=LR,
                                      accumulate_steps=accumulate_steps)
    return loc, enc, state


def _port_from(loc, jstate_, accumulate_steps=1):
    enc = BrainEncoder(num_subjects=S, loc=loc, D1=D1, D2=D2, F=F, K=K, channels_last_io=True)
    state = create_train_state(enc, lr=LR, accumulate_steps=accumulate_steps, device="cpu")
    params = jax.tree.map(np.asarray, jstate_.params)
    load_flax_train(state.encoder, state.clip, params, jax.tree.map(np.asarray, jstate_.batch_stats))
    return state


def _jax_mask(enc, jst, batch, key):
    """The (C,) mask the JAX train step draws with dropout key ``key``."""
    X = jsteps._maybe_collate({k: jnp.asarray(v) for k, v in batch.items()}, COLLATE)
    _, mut = enc.apply({"params": jst.params["encoder"], "batch_stats": jst.batch_stats}, X,
                       jnp.asarray(batch["subject_idxs"]), train=True,
                       mutable=["batch_stats", "intermediates"], rngs={"dropout": key})
    return np.asarray(mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0])


def _port_batch(b):
    # subject ids stay on the host, as the train step takes them
    return {k: _t(v) for k, v in b.items()}


def _assert_stats(tenc, jstats, mean_atol):
    """BN running stats: variances at 1e-5, means at ``mean_atol``."""
    flat = dict(tenc.named_buffers())
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstats)[0]:
        name = ".".join(p.key for p in path)
        atol = mean_atol if name.endswith("mean") else 1e-5
        np.testing.assert_allclose(flat[name].numpy(), np.asarray(leaf), rtol=1e-5, atol=atol, err_msg=name)


def _jax_grads(enc, jst, batch, key):
    """First-step gradients of the JAX train step's loss (its loss_fn, as
    ``steps._build_train_step`` writes it)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        X = jsteps._maybe_collate(jb, COLLATE)
        Z, _ = enc.apply({"params": params["encoder"], "batch_stats": jst.batch_stats}, X,
                         jb["subject_idxs"], train=True, mutable=["batch_stats"], rngs={"dropout": key})
        return j_clip_loss(jb["Y"], Z, params["clip"]["temp"][0])

    return jax.grad(loss_fn)(jst.params)


def _zero_grad_entries(path):
    """Parameter entries whose gradient is zero in exact arithmetic, so both
    sides hold rounding noise there: the conv0/conv1 biases of a ConvBlock
    (a batch-stat BN follows and removes any constant) and z_re[:, 0] (the
    (k, l) = (0, 0) Fourier term adds the same logit to every channel, which
    the softmax ignores). None: no such entry."""
    keys = [p.key for p in path]
    if keys[-1] == "bias" and keys[-2] in ("conv0", "conv1") and keys[-3].startswith("conv"):
        return np.s_[...]
    if keys[-1] == "z_re":
        return np.s_[:, 0]
    return None


def test_train_trajectory_matches_jax():
    """Tolerances (f32, CPU, the same inputs, weights and masks):
    loss and temperature every step at rtol 1e-4 (sums in another order),
    top-k equal. The first step's gradients at 1e-4 of each tensor's largest
    entry plus 1e-5 of the model's largest gradient (the zero-gradient
    entries of ``_zero_grad_entries`` hold rounding noise of about 1e-5 of
    the gradient scale). Adam turns that noise into updates of about
    ±LR·sign(noise), so those entries may drift apart by up to 2·LR a step:
    after 10 steps they are held at 2·LR·10, the BN running means (which
    average those biases in) at 2·LR·(steps so far), and every other
    parameter at 1e-5 absolute, the running variances at 1e-5."""
    loc, enc, jst = _jax_setup()
    tst = _port_from(loc, jst)
    jstep = jsteps.make_train_step(enc, collate=COLLATE, donate=False)
    tstep = make_train_step(collate=COLLATE)
    base_key = jax.random.PRNGKey(3)
    for i, b in enumerate(_batches(STEPS)):
        key = jax.random.fold_in(base_key, jst.step)
        mask = _jax_mask(enc, jst, b, key)
        assert 0 < mask.sum() < C  # the dropout really drops some sensors
        if i == 0:
            jgrads = _jax_grads(enc, jst, b, key)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()}, base_key)
        tst, tm = tstep(tst, _port_batch(b), drop_mask=_t(mask))
        if i == 0:
            named = dict(tst.encoder.named_parameters())
            leaves = jax.tree_util.tree_flatten_with_path(jgrads["encoder"])[0]
            gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in leaves)
            for path, g in leaves:
                name = ".".join(p.key for p in path)
                g = np.asarray(g)
                np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0,
                                           atol=1e-4 * float(np.abs(g).max()) + 1e-5 * gmax, err_msg=name)
            np.testing.assert_allclose(tst.clip.temp.grad.numpy(), np.asarray(jgrads["clip"]["temp"]),
                                       rtol=1e-4, atol=1e-7)
        for k in ("loss", "temp"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"step {i} {k}")
        for k in ("top1", "top10"):
            assert float(tm[k]) == float(jm[k]), (i, k)
        _assert_stats(tst.encoder, jax.tree.map(np.asarray, jst.batch_stats), mean_atol=2 * LR * (i + 1))
    assert tst.step == int(jst.step) == STEPS
    params, _ = flax_train_from_state(tst.encoder, tst.clip)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jst.params))[0]:
        got = params
        for p in path:
            got = got[p.key]
        noisy = _zero_grad_entries(path)
        if noisy is not None:
            np.testing.assert_allclose(got[noisy], leaf[noisy], rtol=0, atol=2 * LR * STEPS, err_msg=str(path))
            got, leaf = got.copy(), leaf.copy()
            got[noisy] = leaf[noisy] = 0
        np.testing.assert_allclose(got, leaf, rtol=0, atol=1e-5, err_msg=str(path))


def test_adam_step_matches_optax():
    """One Adam step on a fixed gradient: the same update as optax.adam
    (f32, rtol 1e-6)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    opt = make_optimizer([tp], LR)
    assert isinstance(opt, torch.optim.Adam)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_multisteps_matches_optax():
    """k=3: parameters stay put for two calls, then move by Adam on the mean
    of the three gradients, as optax.MultiSteps does (rtol 1e-6)."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    tx = optax.MultiSteps(optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8), every_k_schedule=3)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    opt = make_optimizer([tp], LR, accumulate_steps=3)
    assert isinstance(opt, MultiSteps)
    for i in range(7):
        g = rng.normal(size=(4, 3)).astype(np.float32)
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        tp.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7, err_msg=str(i))
        if i < 2:
            np.testing.assert_array_equal(tp.detach().numpy(), p0)
    assert not np.array_equal(tp.detach().numpy(), p0)


def test_scan_equals_single_steps():
    """make_train_step_scan over a stacked batch equals k single steps
    (bitwise: the same ops in the same order)."""
    loc, _, jst = _jax_setup()
    a, b = _port_from(loc, jst), _port_from(loc, jst)
    bs = _batches(3, seed=5)
    masks = torch.stack([(torch.arange(C) % (i + 3) != 0).float() for i in range(3)])
    single = make_train_step(collate=COLLATE)
    ms = []
    for i, bt in enumerate(bs):
        a, m = single(a, _port_batch(bt), drop_mask=masks[i])
        ms.append(m)
    stacked = {k: _t(np.stack([bt[k] for bt in bs])) for k in bs[0]}
    b, mk = make_train_step_scan(make_train_step(collate=COLLATE))(b, stacked, drop_masks=masks)
    assert mk["loss"].shape == (3,) and b.step == a.step == 3
    for k in ms[0]:
        np.testing.assert_array_equal(mk[k].numpy(), torch.stack([m[k] for m in ms]).numpy())
    for p, q in zip(a.encoder.state_dict().values(), b.encoder.state_dict().values()):
        assert torch.equal(p, q)


def test_forward_step_matches_jax():
    """Train-mode forward without an update: metrics and new BN stats equal
    JAX's make_train_forward_step (rtol 1e-4); parameters do not move."""
    loc, enc, jst = _jax_setup()
    tst = _port_from(loc, jst)
    b = _batches(1, seed=7)[0]
    key = jax.random.PRNGKey(11)
    mask = _jax_mask(enc, jst, b, jax.random.fold_in(key, jst.step))
    jst2, jm = jsteps.make_train_forward_step(enc, collate=COLLATE)(jst, {k: jnp.asarray(v) for k, v in b.items()},
                                                                    key)
    before = {k: v.clone() for k, v in tst.encoder.named_parameters()}
    tst, tm = make_train_forward_step(collate=COLLATE)(tst, _port_batch(b), drop_mask=_t(mask))
    for k in ("loss", "top1", "top10", "temp"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    _assert_stats(tst.encoder, jax.tree.map(np.asarray, jst2.batch_stats), mean_atol=1e-5)
    for k, v in tst.encoder.named_parameters():
        assert torch.equal(v, before[k]), k
    assert tst.step == 0


@pytest.mark.parametrize("chunked", [False, True])
def test_eval_matches_jax(chunked):
    """make_eval_step / make_chunked_eval (chunk 3 of 8 rows, so the tail
    chunk is padded) against JAX's with kernel retrieval (Pallas interpret):
    loss at rtol 1e-5, top-k equal."""
    loc, enc, jst = _jax_setup()
    # non-trivial running statistics, so eval differs from train mode
    rng = np.random.default_rng(5)
    jst = jst.replace(batch_stats=jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray((rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                                     else 0.2 * rng.normal(size=a.shape)).astype(np.float32)),
        jst.batch_stats))
    tst = _port_from(loc, jst)
    b = _batches(1, seed=21)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if chunked:
        jm = jsteps.make_chunked_eval(enc, collate=COLLATE, chunk_size=3, use_pallas_retrieval=True)(jst, jb)
        tm = make_chunked_eval(collate=COLLATE, chunk_size=3)(tst, _port_batch(b))
    else:
        jm = jsteps.make_eval_step(enc, collate=COLLATE, use_pallas_retrieval=True)(jst, jb)
        tm = make_eval_step(collate=COLLATE)(tst, _port_batch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for k in ("top1", "top10"):
        assert float(tm[k]) == float(jm[k]), k


def test_train_state_bridge_round_trip():
    loc, _, jst = _jax_setup()
    tst = _port_from(loc, jst)
    params, stats = flax_train_from_state(tst.encoder, tst.clip)
    want = jax.tree.map(np.asarray, jst.params)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert params["clip"]["temp"].shape == (1,) and float(params["clip"]["temp"][0]) == pytest.approx(5.1)
    bad = {"encoder": want["encoder"], "clip": {"temp": np.zeros((2,), np.float32)}}
    with pytest.raises(ValueError, match="temperature"):
        load_flax_train(tst.encoder, tst.clip, bad, jax.tree.map(np.asarray, jst.batch_stats))


def test_create_train_state_defaults_to_cuda():
    enc = BrainEncoder(num_subjects=S, loc=np.zeros((C, 2), np.float32), D1=D1, D2=D2, F=F, K=K)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(enc)
    st = create_train_state(enc, device="cpu")
    assert st.step == 0 and st.device.type == "cpu" and float(st.clip.temp.detach()[0]) == pytest.approx(5.1)
    n = sum(len(g["params"]) for g in st.optimizer.param_groups)
    assert n == len(list(enc.parameters())) + 1  # the temperature trains too
