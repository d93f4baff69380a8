"""The port's fused train path and its ``pallas_taps`` encoder against the
JAX package, in f32 on the CPU: ``conv_block_train`` (K6's plain stages, its
11 cotangents against ``jax.vjp``), ``fused_train_forward``, the
``pallas_taps`` encoder (K5), one fused step against one module step, and a
3-step fused trajectory against JAX's ``make_train_step(fused_blocks=True)``.
JAX's Pallas kernels run in interpret mode, as tests/test_fused_train.py runs
them. Weights cross through ``models/params_bridge.py``; each port step gets
the drop mask that the JAX step draws (sown as ``intermediates/drop_mask``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu.models.fused_train import fused_train_forward as j_fused_train_forward  # noqa: E402
from speech_decoding_tpu.models.loss import clip_loss as j_clip_loss  # noqa: E402
from speech_decoding_tpu.ops.pallas.conv_block_train import conv_block_train as j_conv_block_train  # noqa: E402
from speech_decoding_tpu.ops.scaling import window_scale_stats as j_window_scale_stats  # noqa: E402
from speech_decoding_tpu.training import state as jstate  # noqa: E402
from speech_decoding_tpu.training import steps as jsteps  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.fused_train import fused_train_forward  # noqa: E402
from speech_decoding_tpu_torch.models.loss import clip_loss  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import flax_train_from_state, load_flax, load_flax_train  # noqa: E402
from speech_decoding_tpu_torch.ops import conv_block_train as tcbt  # noqa: E402
from speech_decoding_tpu_torch.training import create_train_state, make_train_step  # noqa: E402

torch.set_num_threads(1)

S, D1, D2, F, K, B, T, C = 3, 16, 24, 32, 4, 8, 48, 208
LR = 1e-3
COLLATE = {"baseline_len_samp": 10, "clamp_lim": 20.0, "clamp": True, "precomputed": True, "channels_last": True}
KW = dict(num_subjects=S, D1=D1, D2=D2, F=F, K=K, d_drop=0.3)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_scaled(got, want, rel, floor=0.0, err_msg=""):
    """|got − want| ≤ rel·max|want| + floor (sums in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * float(np.abs(want).max()) + floor,
                               err_msg=err_msg)


# -- one block: conv_block_train against jax.vjp of the Pallas custom VJP --------------------


@pytest.mark.parametrize("k,batch", [(0, 3), (2, 4)])
def test_conv_block_train_matches_jax_vjp(k, batch):
    """k=0 (Cin=16 ≠ C=24, no skip; B=3, JAX's one-row grid) and k=2 (skip,
    d0=16 against T=48; B=4, its four-row grid):
    out at 1e-5 of its largest entry, the four batch statistics at rtol 1e-5,
    and all 11 cotangents at 1e-4 of each tensor's largest entry plus 1e-5
    of the largest cotangent (conv0/conv1 biases feed a batch-stat BN: zero
    in exact arithmetic, rounding noise on both sides)."""
    rng = np.random.default_rng(10 * k + batch)
    cin = D1 if k == 0 else D2
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    args = [f(batch, T, cin), f(3, cin, D2) / np.sqrt(3 * cin), 0.1 * f(D2), 1 + 0.2 * f(D2), 0.1 * f(D2),
            f(3, D2, D2) / np.sqrt(3 * D2), 0.1 * f(D2), 1 + 0.2 * f(D2), 0.1 * f(D2),
            f(3, D2, 2 * D2) / np.sqrt(3 * D2), 0.1 * f(2 * D2)]
    gy = f(batch, T, D2)

    @jax.jit
    def jax_block(*a):
        (out, stats), vjp = jax.vjp(lambda *b: j_conv_block_train(*b, k, 1e-5, True), *a)
        return out, stats, vjp((jnp.asarray(gy), jax.tree.map(jnp.zeros_like, stats)))

    jout, jstats, jgrads = jax_block(*[jnp.asarray(a) for a in args])
    jgrads = [np.asarray(g) for g in jgrads]

    targs = [_t(a).requires_grad_() for a in args]
    out, stats = tcbt.conv_block_train(*targs, k)
    assert all(not s.requires_grad for s in stats)
    out.backward(_t(gy))
    _close_scaled(out.detach().numpy(), jout, 1e-5)
    for got, want in zip(stats, jstats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    gmax = max(float(np.abs(g).max()) for g in jgrads)
    names = ["x", "w0", "b0", "g0", "beta0", "w1", "b1", "g1", "beta1", "w2", "b2"]
    for name, a, want in zip(names, targs, jgrads):
        _close_scaled(a.grad.numpy(), want, 1e-4, 1e-5 * gmax, err_msg=name)


def test_stage_helpers_match_jax():
    """_dgelu_f32, _stats_from_sums and flip_taps against the JAX helpers
    (the erf differs: torch.erf against Abramowitz–Stegun, |err| ≤ 1.5e-7)."""
    from speech_decoding_tpu.ops.pallas import conv_block_train as jcbt

    rng = np.random.default_rng(0)
    u = rng.normal(size=(5, 7)).astype(np.float32) * 3
    np.testing.assert_allclose(tcbt._dgelu_f32(_t(u)).numpy(), np.asarray(jcbt._dgelu_f32(jnp.asarray(u))),
                               rtol=0, atol=1e-6)
    s = np.stack([rng.normal(size=6), 2 + rng.uniform(size=6)]).astype(np.float32) * 10
    for got, want in zip(tcbt._stats_from_sums(_t(s), 10), jcbt._stats_from_sums(jnp.asarray(s), 10)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    w = rng.normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tcbt.flip_taps(_t(w)).numpy(), np.asarray(jcbt._flip_t(jnp.asarray(w))))


# -- the fused forward ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_encoder():
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(B, T, C)).astype(np.float32)
    sidx = (np.arange(B) % S).astype(np.int32)
    enc = JaxEncoder(loc=loc, channels_last_io=True, **KW)
    v = enc.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(X), sidx,
                 train=False)
    # the same parameters serve both layouts
    return loc, X, sidx, {True: (enc, v), False: (JaxEncoder(loc=loc, channels_last_io=False, **KW), v)}


def _port_encoder(loc, variables, channels_last, conv_impl="gemm"):
    enc = BrainEncoder(loc=loc, channels_last_io=channels_last, conv_impl=conv_impl, **KW)
    return load_flax(enc, _np(variables["params"]), _np(variables["batch_stats"]))


@pytest.mark.parametrize("channels_last", [True, False])
def test_fused_train_forward_matches_jax(jax_encoder, channels_last):
    """Z at rtol 2e-4 / atol 2e-5 and the new BN running statistics at rtol
    1e-4 / atol 1e-6 (tests/test_fused_train.py's tolerances), with JAX's
    sown drop mask handed to the port."""
    loc, X, sidx, variables = jax_encoder
    enc, v = variables[channels_last]
    Xin = X if channels_last else np.swapaxes(X, 1, 2).copy()
    key = jax.random.PRNGKey(3)
    jZ, jstats = jax.jit(lambda *a: j_fused_train_forward(enc, *a, interpret=True))(
        v["params"], v["batch_stats"], jnp.asarray(Xin), sidx, key)
    # the fused path's SubjectBlock call, with its sown mask
    _, mut = enc.apply({"params": v["params"]}, jnp.asarray(Xin), sidx, True, True, rngs={"dropout": key},
                       mutable=["intermediates"])
    mask = np.asarray(mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0])
    assert 0 < mask.sum() < C
    tenc = _port_encoder(loc, v, channels_last)
    with torch.no_grad():
        Z = fused_train_forward(tenc, _t(Xin), _t(sidx), drop_mask=_t(mask))
    np.testing.assert_allclose(Z.numpy(), np.asarray(jZ), rtol=2e-4, atol=2e-5)
    bufs = dict(tenc.named_buffers())
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np(jstats))[0]:
        name = ".".join(p.key for p in path)
        np.testing.assert_allclose(bufs[name].numpy(), leaf, rtol=1e-4, atol=1e-6, err_msg=name)


def test_pallas_taps_encoder_matches_jax(jax_encoder):
    """BrainEncoder(conv_impl="pallas_taps"): every k=3 conv takes the K5
    route; the train-mode CLIP loss at rtol 1e-5 and every parameter
    gradient at 1e-4 of its largest entry plus 1e-5 of the largest gradient,
    against JAX's pallas_taps encoder (Pallas in interpret mode)."""
    loc, X, sidx, variables = jax_encoder
    _, v = variables[True]
    enc = JaxEncoder(loc=loc, channels_last_io=True, conv_impl="pallas_taps", **KW)
    Y = np.random.default_rng(8).normal(size=(B, T, F)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def loss_fn(params):
        Z, mut = enc.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(X), sidx, train=True,
                           mutable=["batch_stats", "intermediates"], rngs={"dropout": key})
        return j_clip_loss(jnp.asarray(Y), Z, jnp.float32(1.0)), mut["intermediates"]

    (jloss, inter), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    mask = np.asarray(inter["subject_block"]["spatial_attention"]["drop_mask"][0])
    tenc = _port_encoder(loc, v, True, conv_impl="pallas_taps")
    assert all(blk.conv0.impl == blk.conv2.impl == "pallas_taps" for blk in tenc.conv_blocks)
    Z = tenc(_t(X), _t(sidx), train=True, drop_mask=_t(mask))
    loss = clip_loss(_t(Y), Z, torch.tensor(1.0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    named = dict(tenc.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(_np(jgrads))[0]
    gmax = max(float(np.abs(g).max()) for _, g in leaves)
    for path, g in leaves:
        name = ".".join(p.key for p in path)
        _close_scaled(named[name].grad.numpy(), g, 1e-4, 1e-5 * gmax, err_msg=name)


# -- the fused train step ------------------------------------------------------------------


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        X = (rng.normal(size=(B, T, C)) * 10 + 3).astype(np.float32)
        out.append({"X": X, "Y": rng.normal(size=(B, T, F)).astype(np.float32),
                    "subject_idxs": rng.integers(0, S, B).astype(np.int32),
                    "scale_stats": np.asarray(j_window_scale_stats(jnp.swapaxes(jnp.asarray(X), 1, 2)))})
    return out


@pytest.fixture(scope="module")
def jax_train():
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    enc = JaxEncoder(loc=loc, use_pallas=True, conv_impl="gemm_pdw", channels_last_io=True, **KW)
    b0 = _batches(1, seed=99)[0]
    state = jstate.create_train_state(enc, jax.random.PRNGKey(2), jnp.asarray(b0["X"]),
                                      jnp.asarray(b0["subject_idxs"]), lr=LR)
    return loc, enc, state


def _port_state(loc, jst):
    enc = BrainEncoder(loc=loc, channels_last_io=True, **KW)
    state = create_train_state(enc, lr=LR, device="cpu")
    load_flax_train(state.encoder, state.clip, _np(jst.params), _np(jst.batch_stats))
    return state


def _jax_mask(enc, jst, batch, key):
    """The (C,) mask the JAX train step draws with dropout key ``key``."""
    X = jsteps._maybe_collate({k: jnp.asarray(v) for k, v in batch.items()}, COLLATE)
    _, mut = enc.apply({"params": jst.params["encoder"]}, X, jnp.asarray(batch["subject_idxs"]), True, True,
                       mutable=["intermediates"], rngs={"dropout": key})
    return np.asarray(mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0])


def _port_batch(b):
    return {k: _t(v) for k, v in b.items()}


def _zero_grad_entries(name):
    """Entries whose gradient is zero in exact arithmetic (see
    tests/test_torch_train.py): the conv0/conv1 biases of a ConvBlock and
    z_re[:, 0]."""
    parts = name.split(".")
    if parts[-1] == "bias" and parts[-2] in ("conv0", "conv1") and parts[-3].startswith("conv"):
        return np.s_[...]
    if parts[-1] == "z_re":
        return np.s_[:, 0]
    return None


def test_fused_step_equals_module_step(jax_train):
    """One port step with fused_blocks=True against one with
    fused_blocks=False from the same state, batch and mask: loss, top-k and
    temperature at rtol 1e-5; gradients at 1e-4 of each tensor's largest
    entry plus 1e-5 of the largest gradient; the new BN running statistics
    at 1e-5 (the same function, sums in another order)."""
    loc, _, jst = jax_train
    b = _port_batch(_batches(1, seed=4)[0])
    mask = (torch.arange(C) % 7 != 2).float()
    out = []
    for fused in (False, True):
        st = _port_state(loc, jst)
        st, m = make_train_step(collate=COLLATE, fused_blocks=fused)(st, b, drop_mask=mask)
        out.append((st, m))
    (ms, mm), (fs, fm) = out
    for k in ("loss", "temp"):
        np.testing.assert_allclose(float(fm[k]), float(mm[k]), rtol=1e-5, err_msg=k)
    for k in ("top1", "top10"):
        assert float(fm[k]) == float(mm[k])
    mod = dict(ms.encoder.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in mod.values())
    for name, p in fs.encoder.named_parameters():
        _close_scaled(p.grad.numpy(), mod[name].grad.numpy(), 1e-4, 1e-5 * gmax, err_msg=name)
    bufs = dict(ms.encoder.named_buffers())
    for name, buf in fs.encoder.named_buffers():
        if name.endswith(("mean", "var")):
            np.testing.assert_allclose(buf.numpy(), bufs[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def test_fused_trajectory_matches_jax(jax_train):
    """3 steps of make_train_step(fused_blocks=True) against JAX's (Pallas
    in interpret mode), the same batches, weights and masks: loss and
    temperature every step at rtol 1e-4, top-k equal; BN running variances
    at 1e-5, means at 2·LR·(steps so far); after 3 steps the zero-gradient
    entries at 2·LR·3 (Adam turns their rounding noise into ±LR steps) and
    every other parameter at 1e-5."""
    loc, enc, jst = jax_train
    tst = _port_state(loc, jst)
    jstep = jsteps.make_train_step(enc, collate=COLLATE, donate=False, fused_blocks=True)
    tstep = make_train_step(collate=COLLATE, fused_blocks=True)
    base_key = jax.random.PRNGKey(5)
    steps = 3
    for i, b in enumerate(_batches(steps, seed=6)):
        mask = _jax_mask(enc, jst, b, jax.random.fold_in(base_key, jst.step))
        assert 0 < mask.sum() < C
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()}, base_key)
        tst, tm = tstep(tst, _port_batch(b), drop_mask=_t(mask))
        for k in ("loss", "temp"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"step {i} {k}")
        for k in ("top1", "top10"):
            assert float(tm[k]) == float(jm[k]), (i, k)
        bufs = dict(tst.encoder.named_buffers())
        for path, leaf in jax.tree_util.tree_flatten_with_path(_np(jst.batch_stats))[0]:
            name = ".".join(p.key for p in path)
            atol = 2 * LR * (i + 1) if name.endswith("mean") else 1e-5
            np.testing.assert_allclose(bufs[name].numpy(), leaf, rtol=1e-5, atol=atol, err_msg=name)
    params, _ = flax_train_from_state(tst.encoder, tst.clip)
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np(jst.params))[0]:
        got = params
        for p in path:
            got = got[p.key]
        name = ".".join(p.key for p in path)
        noisy = _zero_grad_entries(name)
        if noisy is not None:
            np.testing.assert_allclose(got[noisy], leaf[noisy], rtol=0, atol=2 * LR * steps, err_msg=name)
            got, leaf = got.copy(), leaf.copy()
            got[noisy] = leaf[noisy] = 0
        np.testing.assert_allclose(got, leaf, rtol=0, atol=1e-5, err_msg=name)
