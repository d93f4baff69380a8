"""Remat (``tpu.remat``) in the port, f32 on the CPU: the ConvBlocks
recomputed in the backward pass (``torch.utils.checkpoint``) give the plain
step's loss, gradients and running statistics (updated once a step), on the
module convs and on ``pallas_taps`` (K5/K2's plain versions here); three
remat steps match JAX's train step with ``remat=True`` (``nn.remat`` over
each ConvBlock, Pallas in interpret mode) from the same weights and drop
masks; remat keeps fewer activations; it changes nothing in eval, in a
forward without gradients, or under ``fused_train_blocks`` (K6 runs its own
stages); ``from_config`` and the scale run's encoder read ``tpu.remat``, and
the state_dict keys stay as they are.
The data-parallel remat step is in ``tests/test_torch_sharded_paths.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu.ops.scaling import window_scale_stats as j_window_scale_stats  # noqa: E402
from speech_decoding_tpu.training import state as jstate  # noqa: E402
from speech_decoding_tpu.training import steps as jsteps  # noqa: E402
from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, ConvBlock  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import flax_train_from_state, load_flax_train  # noqa: E402
from speech_decoding_tpu_torch.tools import scale_run  # noqa: E402
from speech_decoding_tpu_torch.training import (  # noqa: E402
    create_train_state,
    make_train_forward_step,
    make_train_step,
)

torch.set_num_threads(1)

S, D1, D2, F, K, B, T, C = 3, 16, 24, 32, 4, 8, 48, 208
LR = 1e-3
STEPS = 3
COLLATE = {"baseline_len_samp": 10, "clamp_lim": 20.0, "clamp": True, "precomputed": True,
           "channels_last": True}
KW = dict(num_subjects=S, D1=D1, D2=D2, F=F, K=K)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _batches(n, seed=0):
    """n channels-last batches with precomputed (JAX) scale stats, numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        X = (rng.normal(size=(B, T, C)) * 10 + 3).astype(np.float32)
        out.append({"X": X, "Y": rng.normal(size=(B, T, F)).astype(np.float32),
                    "subject_idxs": rng.integers(0, S, B).astype(np.int32),
                    "scale_stats": np.asarray(j_window_scale_stats(jnp.swapaxes(jnp.asarray(X), 1, 2)))})
    return out


@pytest.fixture(scope="module")
def jax_remat():
    """JAX's remat encoder and its initial train state."""
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    enc = JaxEncoder(loc=loc, use_pallas=True, conv_impl="gemm_pdw", channels_last_io=True, remat=True, **KW)
    b0 = _batches(1, seed=99)[0]
    state = jstate.create_train_state(enc, jax.random.PRNGKey(2), jnp.asarray(b0["X"]),
                                      jnp.asarray(b0["subject_idxs"]), lr=LR)
    return loc, enc, state


def _port_state(loc, jst, remat, conv_impl="gemm"):
    enc = BrainEncoder(loc=loc, channels_last_io=True, remat=remat, conv_impl=conv_impl, **KW)
    state = create_train_state(enc, lr=LR, device="cpu")
    load_flax_train(state.encoder, state.clip, jax.tree.map(np.asarray, jst.params),
                    jax.tree.map(np.asarray, jst.batch_stats))
    return state


def _jax_mask(enc, jst, batch, key):
    """The (C,) mask the JAX train step draws with dropout key ``key``."""
    X = jsteps._maybe_collate({k: jnp.asarray(v) for k, v in batch.items()}, COLLATE)
    _, mut = enc.apply({"params": jst.params["encoder"], "batch_stats": jst.batch_stats}, X,
                       jnp.asarray(batch["subject_idxs"]), train=True,
                       mutable=["batch_stats", "intermediates"], rngs={"dropout": key})
    return np.asarray(mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0])


class _BlockCalls:
    """Counts ConvBlock forward calls (a recomputation calls each block again)."""

    def __init__(self, encoder):
        self.n = 0
        self.handles = [blk.register_forward_pre_hook(self._hook) for blk in encoder.conv_blocks]

    def _hook(self, module, args):
        self.n += 1

    def remove(self):
        for h in self.handles:
            h.remove()


def _step(state, batch, mask, fused=False):
    """One step; returns metrics, gradients, running statistics and the
    number of ConvBlock forward calls it made."""
    calls = _BlockCalls(state.encoder)
    state, m = make_train_step(collate=COLLATE, fused_blocks=fused)(state, batch, drop_mask=mask)
    calls.remove()
    grads = {n: p.grad.clone() for n, p in state.encoder.named_parameters()}
    grads["clip.temp"] = state.clip.temp.grad.clone()
    stats = {n: b.clone() for n, b in state.encoder.named_buffers() if n.endswith(("mean", "var"))}
    return {k: float(v) for k, v in m.items()}, grads, stats, calls.n


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("conv_impl", ["gemm", "pallas_taps"])
def test_remat_step_equals_plain_step(jax_remat, conv_impl):
    """The same step with and without remat: loss, top-k and temperature
    equal, every gradient and running statistic within 1e-6 (the same
    arithmetic recomputed: bitwise in practice). The recomputation really
    ran (10 block calls against 5), and the statistics moved once: the
    remat step's equal the plain step's, which differ from the initial."""
    loc, _, jst = jax_remat
    batch = {k: _t(v) for k, v in _batches(1, seed=4)[0].items()}
    mask = (torch.arange(C) % 7 != 2).float()
    init = {n: b.clone() for n, b in _port_state(loc, jst, False).encoder.named_buffers()}
    plain = _step(_port_state(loc, jst, False, conv_impl), batch, mask)
    remat = _step(_port_state(loc, jst, True, conv_impl), batch, mask)
    assert remat[0] == plain[0]
    assert _max_diff(remat[1], plain[1]) <= 1e-6
    assert _max_diff(remat[2], plain[2]) <= 1e-6
    assert (plain[3], remat[3]) == (5, 10)
    assert min(float((plain[2][n] - init[n]).abs().max()) for n in plain[2]) > 1e-4


def test_remat_trajectory_matches_jax(jax_remat):
    """3 port steps with remat against JAX's train step with ``remat=True``,
    the same batches, weights and masks. Tolerances of
    tests/test_torch_train.py's trajectory: loss and temperature at rtol
    1e-4, top-k equal, BN running variances at 1e-5 and means at
    2·LR·(steps so far); after 3 steps the zero-gradient entries (conv0/conv1
    biases, z_re[:, 0]) at 2·LR·3 and every other parameter at 1e-5."""
    loc, enc, jst = jax_remat
    tst = _port_state(loc, jst, True)
    jstep = jsteps.make_train_step(enc, collate=COLLATE, donate=False)
    tstep = make_train_step(collate=COLLATE)
    base_key = jax.random.PRNGKey(3)
    for i, b in enumerate(_batches(STEPS)):
        mask = _jax_mask(enc, jst, b, jax.random.fold_in(base_key, jst.step))
        assert 0 < mask.sum() < C
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()}, base_key)
        tst, tm = tstep(tst, {k: _t(v) for k, v in b.items()}, drop_mask=_t(mask))
        for k in ("loss", "temp"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"step {i} {k}")
        for k in ("top1", "top10"):
            assert float(tm[k]) == float(jm[k]), (i, k)
        flat = dict(tst.encoder.named_buffers())
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jst.batch_stats))[0]:
            name = ".".join(p.key for p in path)
            atol = 2 * LR * (i + 1) if name.endswith("mean") else 1e-5
            np.testing.assert_allclose(flat[name].numpy(), leaf, rtol=1e-5, atol=atol, err_msg=name)
    params, _ = flax_train_from_state(tst.encoder, tst.clip)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jst.params))[0]:
        got = params
        for p in path:
            got = got[p.key]
        keys = [p.key for p in path]
        noisy = None
        if keys[-1] == "bias" and keys[-2] in ("conv0", "conv1") and keys[-3].startswith("conv"):
            noisy = np.s_[...]
        elif keys[-1] == "z_re":
            noisy = np.s_[:, 0]
        if noisy is not None:
            np.testing.assert_allclose(got[noisy], leaf[noisy], rtol=0, atol=2 * LR * STEPS, err_msg=str(path))
            got, leaf = got.copy(), leaf.copy()
            got[noisy] = leaf[noisy] = 0
        np.testing.assert_allclose(got, leaf, rtol=0, atol=1e-5, err_msg=str(path))


def test_remat_keeps_fewer_activations(jax_remat):
    """What autograd saves during a train forward (the bytes an outer
    saved-tensors hook sees): with remat, each ConvBlock keeps only its
    input, so at least half of the plain forward's saved bytes go."""
    loc, _, jst = jax_remat
    batch = {k: _t(v) for k, v in _batches(1, seed=5)[0].items()}
    mask = (torch.arange(C) % 5 != 1).float()
    saved = {}
    for remat in (False, True):
        st = _port_state(loc, jst, remat)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            Z = st.encoder(batch["X"], batch["subject_idxs"], train=True, drop_mask=mask)
        Z.sum().backward()
        saved[remat] = total[0]
    assert saved[True] < 0.5 * saved[False], saved


def test_remat_is_a_no_op_in_eval_and_without_gradients(jax_remat):
    """Eval, and a train forward without gradients (the forward-only step),
    call each block once and give the plain encoder's values exactly."""
    loc, _, jst = jax_remat
    batch = {k: _t(v) for k, v in _batches(1, seed=6)[0].items()}
    mask = (torch.arange(C) % 3 != 0).float()
    out = {}
    for remat in (False, True):
        st = _port_state(loc, jst, remat)
        calls = _BlockCalls(st.encoder)
        with torch.no_grad():
            z_eval = st.encoder(batch["X"], batch["subject_idxs"])
        _, m = make_train_forward_step(collate=COLLATE)(st, batch, drop_mask=mask)
        calls.remove()
        stats = {n: b.clone() for n, b in st.encoder.named_buffers()}
        out[remat] = (z_eval, float(m["loss"]), stats, calls.n)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    assert _max_diff(out[True][2], out[False][2]) == 0.0
    assert out[True][3] == out[False][3] == 10


def test_remat_is_a_no_op_under_fused_train_blocks(jax_remat):
    """``fused_train_blocks`` runs K6's stages (their plain versions here),
    not the module ConvBlocks: with remat set, the fused step is bit for
    bit the fused step without it, and calls no block."""
    loc, _, jst = jax_remat
    batch = {k: _t(v) for k, v in _batches(1, seed=7)[0].items()}
    mask = (torch.arange(C) % 7 != 2).float()
    plain = _step(_port_state(loc, jst, False), batch, mask, fused=True)
    remat = _step(_port_state(loc, jst, True), batch, mask, fused=True)
    assert remat[0] == plain[0]
    assert _max_diff(remat[1], plain[1]) == 0.0 and _max_diff(remat[2], plain[2]) == 0.0
    assert plain[3] == remat[3] == 0


def test_from_config_reads_remat_and_keeps_state_dict_keys():
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    encs = {}
    for flag in ("false", "true"):
        cfg = load_config(None, ["D1=16", "D2=16", "K=4", f"tpu.remat={flag}"])
        encs[flag] = BrainEncoder.from_config(cfg, loc, num_subjects=S, generator=torch.Generator().manual_seed(0))
    assert encs["true"].remat is True and encs["false"].remat is False
    assert list(encs["true"].state_dict()) == list(encs["false"].state_dict())
    for (ka, a), (kb, b) in zip(encs["true"].state_dict().items(), encs["false"].state_dict().items()):
        assert ka == kb and torch.equal(a, b)
    assert all(type(blk) is ConvBlock for blk in encs["true"].conv_blocks)
    # the scale run's encoder (chip_smoke.py's flagship states) reads the key too
    dims = {"C": C, "S": S, "D1": 16, "D2": 16, "F": 32, "K": 4}
    for flag in (False, True):
        assert scale_run.make_encoder(scale_run.flagship_args(1, [f"tpu.remat={str(flag).lower()}"]),
                                      dims).remat is flag
