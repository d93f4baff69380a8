"""The port's data parallelism against one process and against JAX's
8-device mesh, in f32 on the CPU: W gloo ranks spawned as fresh processes
(``parallel.multihost.spawn_ranks``), each passing its block of the same
global inputs (made with numpy from fixed seeds in every process).

  * ``clip_loss_sharded`` (mean and sum) and ``retrieval_metrics_sharded``
    at W=2 and W=4 against the JAX functions on the conftest's mesh and
    against the dense port functions: values to 1e-5, gradients with
    respect to both inputs (and the temperature) at 1e-5 of their largest
    entry, against the dense port loss's and JAX's under GSPMD on the
    mesh-sharded inputs (JAX's shard_map loss has no gradient: ``pmax``
    has no differentiation rule); top-k exactly;
  * synchronized BatchNorm (``TorchBatchNorm`` under a group) and K6's
    plain stages under a group (``conv_block_train``): each rank's output
    and input gradient, the summed parameter gradients (BN scale and bias
    included: returned once, not W times) and the running statistics,
    against one process on the global batch;
  * two data-parallel train steps, module and fused, at W=2 on a global
    batch of 16 against the port's one-process step and JAX's mesh step
    (``tests/test_sharding.py::test_train_step_with_sharded_batch``'s
    GSPMD step; the fused step computes the same function, and its
    one-process twin is held against JAX's fused step in
    ``tests/test_torch_fused_train.py``): loss at rtol 1e-5, top-k exactly,
    the first step's gradients and each step's parameters at rtol 1e-4,
    atol 1e-5, BN running statistics at rtol 1e-5. The entries whose
    gradient is zero in exact arithmetic (the conv biases ahead of a
    batch-stat BN, z_re[:, 0]) hold rounding noise that Adam turns into
    ±lr, so there the parameters are held at 2·lr a step and the running
    means at 2·lr a step before the last (ROADMAP's rule). Every rank's
    whole state (parameters, statistics, Adam moments) is bit-identical
    after every step.

Each spawn is one module fixture; the ranks import no JAX."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, TorchBatchNorm  # noqa: E402
from speech_decoding_tpu_torch.models.classifier import (  # noqa: E402
    retrieval_accuracy_from_similarity,
    retrieval_metrics,
)
from speech_decoding_tpu_torch.models.loss import clip_loss  # noqa: E402
from speech_decoding_tpu_torch.ops.conv_block_train import conv_block_train  # noqa: E402
from speech_decoding_tpu_torch.parallel import (  # noqa: E402
    DataGroup,
    accuracy_from_local_similarity,
    clip_loss_sharded,
    data_group,
    retrieval_metrics_sharded,
    shard_batch,
)
from speech_decoding_tpu_torch.parallel import mesh as mesh_module  # noqa: E402
from speech_decoding_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402
from speech_decoding_tpu_torch.training import create_train_state, make_train_step  # noqa: E402
from speech_decoding_tpu_torch.training.state import state_digest  # noqa: E402

torch.set_num_threads(1)

S, D1, D2, F, K, C, T = 2, 16, 24, 32, 4, 208, 48
B_CLIP, B_RET, B_STEP = 32, 40, 16
LR, STEPS = 1e-3, 2
TEMP = 2.0


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _clip_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B_CLIP, 16, 6)).astype(np.float32), rng.normal(size=(B_CLIP, 16, 6)).astype(np.float32))


def _retrieval_inputs():
    rng = np.random.default_rng(1)
    Z = rng.normal(size=(B_RET, 12, 4)).astype(np.float32)
    return Z, (0.2 * Z + rng.normal(size=Z.shape)).astype(np.float32)


def _bn_inputs():
    rng = np.random.default_rng(2)
    return {"x": (rng.normal(size=(B_STEP, T, D2)) * 3 + 1).astype(np.float32),
            "cot": rng.normal(size=(B_STEP, T, D2)).astype(np.float32),
            "scale": (1 + 0.3 * rng.normal(size=D2)).astype(np.float32),
            "bias": (0.3 * rng.normal(size=D2)).astype(np.float32)}


def _block_inputs(k=1):
    rng = np.random.default_rng(3)
    w = lambda cin, cout: (rng.normal(size=(3, cin, cout)) / np.sqrt(3 * cin)).astype(np.float32)  # noqa: E731
    v = lambda n, s=0.1, c=0.0: (c + s * rng.normal(size=n)).astype(np.float32)  # noqa: E731
    return {"x": rng.normal(size=(B_STEP, T, D2)).astype(np.float32),
            "cot": rng.normal(size=(B_STEP, T, D2)).astype(np.float32),
            "params": [w(D2, D2), v(D2), v(D2, 0.2, 1.0), v(D2), w(D2, D2), v(D2), v(D2, 0.2, 1.0), v(D2),
                       w(D2, 2 * D2), v(2 * D2)], "k": k}


def _step_batches():
    rng = np.random.default_rng(4)
    return [{"X": (rng.normal(size=(B_STEP, C, T)) * 2).astype(np.float32),
             "Y": rng.normal(size=(B_STEP, F, T)).astype(np.float32),
             "subject_idxs": rng.integers(0, S, B_STEP).astype(np.int32)} for _ in range(STEPS)]


def _encoder():
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    return BrainEncoder(num_subjects=S, loc=loc, D1=D1, D2=D2, F=F, K=K, generator=torch.Generator().manual_seed(0))


def _np(t):
    return t.detach().cpu().numpy().copy()


# -- what each rank (or one process, group=None) computes -----------------------------------


def _clip_run(group, x, y):
    """Loss, the gradients of x, y and the temperature, and top-k from the
    logits, for each reduction; the rank's rows under a group."""
    out = {}
    for reduction in ("mean", "sum"):
        xb, yb = _t(x).requires_grad_(), _t(y).requires_grad_()
        temp = torch.tensor(TEMP, requires_grad=True)
        if group is None:
            logits, loss = clip_loss(xb, yb, temp, reduction, return_logits=True)
            topk = retrieval_accuracy_from_similarity(logits.detach())
        else:
            logits, loss = clip_loss_sharded(xb, yb, temp, group, reduction, return_logits=True)
            topk = accuracy_from_local_similarity(logits.detach(), group)
        loss.backward()
        out[reduction] = {"loss": float(loss.detach()), "dx": _np(xb.grad), "dy": _np(yb.grad),
                          "dtemp": float(temp.grad), "topk": [float(a) for a in topk]}
    return out


def _bn_run(group, inp):
    bn = TorchBatchNorm(D2)
    with torch.no_grad():
        bn.scale.copy_(_t(inp["scale"]))
        bn.bias.copy_(_t(inp["bias"]))
    x = _t(inp["x"]).requires_grad_()
    out = bn(x, train=True, group=group)
    (out * _t(inp["cot"])).sum().backward()
    return {"out": _np(out), "dx": _np(x.grad), "dscale": _np(bn.scale.grad), "dbias": _np(bn.bias.grad),
            "mean": _np(bn.mean), "var": _np(bn.var)}


def _block_run(group, inp):
    params = [_t(p).requires_grad_() for p in inp["params"]]
    x = _t(inp["x"]).requires_grad_()
    out, stats = conv_block_train(x, *params, inp["k"], 1e-5, group)
    (out * _t(inp["cot"])).sum().backward()
    return {"out": _np(out), "stats": [_np(s) for s in stats], "dx": _np(x.grad),
            "dparams": [_np(p.grad) for p in params]}


def _steps_run(group, sd, masks, fused):
    """STEPS train steps from the encoder state ``sd`` on the global
    batches (the rank's block under a group): per-step metrics and state
    digest, the first step's gradients, each step's parameters and
    statistics."""
    enc = _encoder()
    enc.load_state_dict({k: _t(v) for k, v in sd.items()})
    st = create_train_state(enc, lr=LR, device="cpu", group=group)
    step = make_train_step(fused_blocks=fused, group=group)
    out = {"metrics": [], "digests": [], "params": [], "buffers": []}
    for i, b in enumerate(_step_batches()):
        b = {k: _t(v) for k, v in b.items()}
        st, m = step(st, b if group is None else shard_batch(b, group), drop_mask=_t(masks[i]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["digests"].append(state_digest(st))
        if i == 0:
            out["grads"] = {n: _np(p.grad) for n, p in st.encoder.named_parameters()}
            out["grads"]["clip.temp"] = _np(st.clip.temp.grad)
        out["params"].append({**{n: _np(p) for n, p in st.encoder.named_parameters()}, "clip.temp": _np(st.clip.temp)})
        out["buffers"].append({n: _np(v) for n, v in st.encoder.named_buffers() if n.endswith(("mean", "var"))})
    return out


def _rank_clip_only():
    group = data_group("cpu")
    x, y = _clip_inputs()
    Z, Y = _retrieval_inputs()
    sl, rl = group.block(B_CLIP), group.block(B_RET)
    return {"clip": _clip_run(group, x[sl], y[sl]),
            "retrieval": [float(a) for a in retrieval_metrics_sharded(_t(Z[rl]), _t(Y[rl]), group)]}


def _rank_all(sd, masks):
    group = data_group("cpu")
    out = _rank_clip_only()
    blk = group.block(B_STEP)
    out["bn"] = _bn_run(group, {k: v[blk] if k in ("x", "cot") else v for k, v in _bn_inputs().items()})
    out["block"] = _block_run(group, {k: v[blk] if k in ("x", "cot") else v for k, v in _block_inputs().items()})
    out["steps"] = {fused: _steps_run(group, sd, masks, fused) for fused in (False, True)}
    return out


# -- the references ---------------------------------------------------------------------------


def _jax_init():
    """JAX's encoder and initial train state on the conftest's 8-device
    mesh, that state in the port's layout, and the drop mask its step
    draws at each step (the mask depends on the step's key only)."""
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.models import BrainEncoder as JaxEncoder
    from speech_decoding_tpu.parallel import make_mesh, shard_batch as j_shard_batch
    from speech_decoding_tpu.training import create_train_state as j_create
    from speech_decoding_tpu_torch.models.params_bridge import load_flax_train

    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    enc = JaxEncoder(num_subjects=S, loc=ch_locations_2d("Gwilliams2022", cache=False), D1=D1, D2=D2, F=F, K=K)
    b0 = _step_batches()[0]
    jst = j_create(enc, jax.random.PRNGKey(0), jnp.asarray(b0["X"]), jnp.asarray(b0["subject_idxs"]), lr=LR)
    port = _encoder()
    clip_ = create_train_state(port, device="cpu").clip
    load_flax_train(port, clip_, jax.tree.map(np.asarray, jst.params), jax.tree.map(np.asarray, jst.batch_stats))
    assert float(clip_.temp.detach()) == pytest.approx(5.1)

    @jax.jit
    def drop_mask(params, stats, jb, key):
        _, mut = enc.apply({"params": params["encoder"], "batch_stats": stats}, jb["X"], jb["subject_idxs"],
                           train=True, mutable=["batch_stats", "intermediates"], rngs={"dropout": key})
        return mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0]

    base_key = jax.random.PRNGKey(3)
    jb = j_shard_batch(b0, mesh)
    masks = [np.asarray(drop_mask(jst.params, jst.batch_stats, jb, jax.random.fold_in(base_key, i)))
             for i in range(STEPS)]
    for mask in masks:
        assert 0 < mask.sum() < C  # the dropout really drops some sensors
    return {"mesh": mesh, "enc": enc, "jst": jst, "base_key": base_key,
            "sd": {k: _np(v) for k, v in port.state_dict().items()}, "masks": masks}


def _jax_refs(init):
    """JAX on the mesh: the sharded CLIP loss (its gradients those of the
    dense loss under GSPMD on mesh-sharded inputs: the shard_map loss has
    none, ``pmax`` has no differentiation rule), the sharded retrieval, and
    the GSPMD train step's first step on the sharded batch (gradients,
    metrics, parameters, statistics)."""
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.models.loss import clip_loss as j_clip_loss
    from speech_decoding_tpu.parallel import clip_loss_sharded as j_cls, retrieval_metrics_sharded as j_rms
    from speech_decoding_tpu.parallel import shard_batch as j_shard_batch
    from speech_decoding_tpu.training import make_train_step as j_make_step

    mesh, enc, jst, base_key = init["mesh"], init["enc"], init["jst"], init["base_key"]
    ref = {"clip": {}}
    x, y = (jnp.asarray(a) for a in _clip_inputs())
    sx, sy = (j_shard_batch({"a": a}, mesh)["a"] for a in _clip_inputs())
    for reduction in ("mean", "sum"):
        fn = lambda a, b, t: j_clip_loss(a, b, t, reduction=reduction)  # noqa: E731
        g = jax.jit(jax.grad(fn, argnums=(0, 1, 2)))(sx, sy, jnp.float32(TEMP))
        ref["clip"][reduction] = {"loss": float(j_cls(x, y, jnp.float32(TEMP), mesh, reduction=reduction)),
                                  "dx": np.asarray(g[0]), "dy": np.asarray(g[1]), "dtemp": float(g[2])}
    ref["retrieval"] = [float(a) for a in j_rms(*(jnp.asarray(a) for a in _retrieval_inputs()), mesh, ks=(1, 10))]

    jb = j_shard_batch(_step_batches()[0], mesh)
    key = jax.random.fold_in(base_key, jst.step)

    @jax.jit
    def grads(params):
        def loss_fn(params):
            Zj, _ = enc.apply({"params": params["encoder"], "batch_stats": jst.batch_stats}, jb["X"],
                              jb["subject_idxs"], train=True, mutable=["batch_stats"], rngs={"dropout": key})
            return j_clip_loss(jb["Y"], Zj, params["clip"]["temp"][0])

        return jax.grad(loss_fn)(params)

    ref["grads"] = _flat_params(jax.tree.map(np.asarray, grads(jst.params)))
    new, jm = j_make_step(enc, donate=False)(jst, jb, base_key)
    ref["metrics"] = {k: float(v) for k, v in jm.items()}
    ref["params"] = _flat_params(jax.tree.map(np.asarray, new.params))
    ref["stats"] = _flat_stats(jax.tree.map(np.asarray, new.batch_stats))
    return ref


def _flat_stats(stats):
    return {f"{blk}.{bn}.{leaf}": v for blk, bns in stats.items() for bn, leaves in bns.items()
            for leaf, v in leaves.items()}


def _flat_params(params):
    """{port parameter name: array} of a JAX-layout params tree."""
    out = {"clip.temp": np.asarray(params["clip"]["temp"])}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = np.asarray(v)

    walk(params["encoder"], "")
    return out


@pytest.fixture(scope="module")
def runs():
    """The W=2 and W=4 ranks (spawned once JAX's initial state and masks
    exist, running while JAX and the one process compute their
    references), JAX's references and the one-process runs."""
    from concurrent.futures import ThreadPoolExecutor

    init = _jax_init()
    with ThreadPoolExecutor(2) as ex:
        w2 = ex.submit(spawn_ranks, _rank_all, 2, (init["sd"], init["masks"]), torch_threads=1, timeout=300)
        w4 = ex.submit(spawn_ranks, _rank_clip_only, 4, torch_threads=1, timeout=300)
        x, y = _clip_inputs()
        one = {"clip": _clip_run(None, x, y), "bn": _bn_run(None, _bn_inputs()),
               "block": _block_run(None, _block_inputs()),
               "steps": {fused: _steps_run(None, init["sd"], init["masks"], fused) for fused in (False, True)}}
        return {"jax": _jax_refs(init), "one": one, 2: w2.result(), 4: w4.result()}


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()), err_msg=what)


# -- the CLIP loss and retrieval -----------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_clip_loss_sharded_matches_jax_and_dense(runs, world, reduction):
    ranks = runs[world]
    dense, jref = runs["one"]["clip"][reduction], runs["jax"]["clip"][reduction]
    for r in ranks:
        got = r["clip"][reduction]
        # the value is the global loss on every rank
        assert got["loss"] == pytest.approx(dense["loss"], rel=1e-5)
        assert got["loss"] == pytest.approx(jref["loss"], rel=1e-5)
    # each rank's input gradients are its rows of the global gradients; the
    # temperature's shares sum to the whole
    for key in ("dx", "dy"):
        got = np.concatenate([r["clip"][reduction][key] for r in ranks])
        _close(got, dense[key], 1e-5, f"{key} vs dense")
        _close(got, jref[key], 1e-5, f"{key} vs JAX")
    dtemp = sum(r["clip"][reduction]["dtemp"] for r in ranks)
    assert dtemp == pytest.approx(dense["dtemp"], rel=1e-5, abs=1e-7)
    assert dtemp == pytest.approx(jref["dtemp"], rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_retrieval_metrics_sharded_matches_jax_and_dense(runs, world):
    Z, Y = _retrieval_inputs()
    dense = [float(a) for a in retrieval_metrics(_t(Z), _t(Y))]
    assert 0 < dense[0] < dense[1] < 1  # the ranks spread
    for r in runs[world]:
        assert r["retrieval"] == dense == pytest.approx(runs["jax"]["retrieval"], abs=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_topk_from_the_ranks_logits_matches_dense(runs, world):
    """top-1/top-10 from each rank's rows of the loss logits, ranked against
    the global diagonal column and summed over the ranks."""
    for reduction in ("mean", "sum"):
        want = runs["one"]["clip"][reduction]["topk"]
        for r in runs[world]:
            assert r["clip"][reduction]["topk"] == want


# -- synchronized BatchNorm -----------------------------------------------------------------------


def test_sync_batchnorm_matches_one_process(runs):
    ranks2, ref = runs[2], runs["one"]["bn"]
    for key in ("out", "dx"):
        _close(np.concatenate([r["bn"][key] for r in ranks2]), ref[key], 1e-5, key)
    for key in ("dscale", "dbias"):
        _close(sum(r["bn"][key] for r in ranks2), ref[key], 1e-5, key)
    for r in ranks2:
        np.testing.assert_allclose(r["bn"]["mean"], ref["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["bn"]["var"], ref["var"], rtol=1e-5)


def test_k6_plain_block_under_a_group_matches_one_process(runs):
    """conv_block_train's plain stages with the group's all-reduces: out,
    statistics and dx against one process; the parameter gradients summed
    over the ranks (BN scale and bias at positions 2, 3, 6, 7: each rank's
    share, not the reduced sum) at 1e-5 of each tensor's largest entry, the
    conv0 and conv1 biases (positions 1 and 5, zero in exact arithmetic
    ahead of a batch-stat BN, so rounding noise on both sides) at 1e-6 of
    the block's largest gradient."""
    ranks2, ref = runs[2], runs["one"]["block"]
    for key in ("out", "dx"):
        _close(np.concatenate([r["block"][key] for r in ranks2]), ref[key], 1e-5, key)
    for r in ranks2:
        for got, want in zip(r["block"]["stats"], ref["stats"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gmax = max(float(np.abs(g).max()) for g in ref["dparams"])
    for i, want in enumerate(ref["dparams"]):
        got = sum(r["block"]["dparams"][i] for r in ranks2)
        if i in (1, 5):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * gmax, err_msg=f"parameter {i}")
            assert np.abs(want).max() < 1e-6 * gmax  # rounding noise indeed
        else:
            _close(got, want, 1e-5, f"parameter {i}")


# -- the train step ----------------------------------------------------------------------------------


def _zero_grad_entries(name):
    """The entries whose gradient is zero in exact arithmetic: the conv0 and
    conv1 biases of a ConvBlock (a batch-stat BN follows) and z_re[:, 0]."""
    parts = name.split(".")
    if parts[-1] == "bias" and parts[-2] in ("conv0", "conv1") and parts[0].startswith("conv"):
        return np.s_[...]
    if parts[-1] == "z_re":
        return np.s_[:, 0]
    return None


def _assert_params(got, want, steps, what):
    for name, w in want.items():
        g, w = np.array(got[name]), np.array(w)
        noisy = _zero_grad_entries(name)
        if noisy is not None:
            np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * LR * steps, err_msg=f"{what} {name}")
            g[noisy] = w[noisy] = 0
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"{what} {name}")


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_step_matches_one_process_and_jax_mesh(runs, fused):
    """Both steps against the port's one process; the first against JAX's
    GSPMD step on the mesh-sharded batch."""
    got, one, jref = runs[2][0]["steps"][fused], runs["one"]["steps"][fused], runs["jax"]
    for i in range(STEPS):
        refs = [(one["metrics"][i], "one process")] + ([(jref["metrics"], "JAX mesh")] if i == 0 else [])
        for ref, name in refs:
            assert got["metrics"][i]["loss"] == pytest.approx(ref["loss"], rel=1e-5), (i, name)
            assert got["metrics"][i]["temp"] == pytest.approx(ref["temp"], rel=1e-5), (i, name)
            for k in ("top1", "top10"):
                assert got["metrics"][i][k] == ref[k], (i, name, k)
    for name, want in one["grads"].items():
        for ref, label in ((want, "one process"), (jref["grads"][name], "JAX mesh")):
            np.testing.assert_allclose(got["grads"][name], ref, rtol=1e-4, atol=1e-5,
                                       err_msg=f"gradient {name} vs {label}")
    _assert_params(got["params"][0], jref["params"], 1, "step 0 vs JAX mesh")
    for name, want in jref["stats"].items():
        np.testing.assert_allclose(got["buffers"][0][name], want, rtol=1e-5, atol=1e-6, err_msg=f"{name} vs JAX")
    for i in range(STEPS):
        _assert_params(got["params"][i], one["params"][i], i + 1, f"step {i} vs one process")
        for name, want in one["buffers"][i].items():
            # the running means average the noisy conv biases in after the first step
            atol = 2 * LR * i + 1e-6 if name.endswith("mean") else 1e-6
            np.testing.assert_allclose(got["buffers"][i][name], want, rtol=1e-5, atol=atol,
                                       err_msg=f"step {i} {name} vs one process")


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_step_ranks_bit_identical(runs, fused):
    """Parameters, BN statistics, temperature and Adam moments: the same
    bytes on every rank after every step."""
    d0, d1 = (r["steps"][fused]["digests"] for r in runs[2])
    assert len(d0) == STEPS and d0 == d1
    assert len(set(d0)) == STEPS  # the state moved each step


# -- the group and batch placement, in one process --------------------------------------------------


def test_data_group_blocks_and_shard_batch():
    g = DataGroup(world=4, rank=2, device=torch.device("cpu"))
    assert g.block(16) == slice(8, 12) and not g.is_primary and DataGroup(2, 0, torch.device("cpu")).is_primary
    with pytest.raises(ValueError, match="not divisible"):
        g.block(10)
    batch = {"X": np.arange(16 * 3, dtype=np.float32).reshape(16, 3), "subject_idxs": np.arange(16, dtype=np.int64)}
    out = shard_batch(batch, g)
    assert torch.equal(out["X"], _t(batch["X"][8:12])) and out["subject_idxs"].dtype == torch.int32
    stacked = {"X": torch.zeros(3, 16, 5), "subject_idxs": torch.zeros(3, 16, dtype=torch.int32)}
    assert shard_batch(stacked, g, axis=1)["X"].shape == (3, 4, 5)


def test_data_group_needs_a_process_group_and_a_card(monkeypatch):
    with pytest.raises(RuntimeError, match="not initialized"):
        data_group("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(mesh_module.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh_module.torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=3 but this machine has 2"):
        mesh_module.rank_device()
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh_module.rank_device() == torch.device("cuda", 1)


def test_data_parallel_step_takes_the_drop_mask():
    """Every rank must drop the same sensors: a step under a group refuses
    to draw its own mask (before any collective)."""
    st = create_train_state(_encoder(), device="cpu")
    b = {k: _t(v) for k, v in _step_batches()[0].items()}
    step = make_train_step(group=DataGroup(world=2, rank=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="drop_mask"):
        step(st, b, generator=torch.Generator().manual_seed(0))
