"""The port's "model" axis against one process and against JAX, f32 on the
CPU: gloo ranks spawned as fresh processes (``parallel.multihost
.spawn_ranks``) on a ("data", "model") grid (``parallel.make_grid``), the
encoder split by ``parallel.partition_encoder`` at min_dim 16, each rank
passing its data block of the same inputs (made with numpy from fixed seeds
in every process), at JAX's tiny shapes (``tests/test_sharding.py``'s TP
test: D1 16, D2 24, F 32, K 4, T 24, B 8, 2 subjects):

  * ``partition_encoder`` splits exactly the leaves JAX's
    ``param_shardings`` splits: the tiny tree at min_dim 16 (21 leaves) and
    32 (7), the flagship's shapes (``jax.eval_shape``) at m=2 (21) and m=4
    (19: 270 % 4 != 0 leaves the subject layers whole), each rank keeping
    its column block (and the spatial attention its bases' rows);
  * 1×2 and 2×2 grids, four Adam steps from JAX's initial state with the
    drop masks JAX sows at each step: the first step's gradients (summed
    over the data axis, gathered over the model axis) against the
    one-process step and JAX's one-device gradients at rtol 1e-3 / atol
    1e-4 (the TP test's bounds), the loss trajectory at rtol 1e-5 / atol
    1e-6, the running statistics at rtol 1e-5, the eval on the grid against
    one process's; every rank's gathered state identical;
  * ``pallas_taps`` and ``fused_train_blocks`` (K5 and K6 on gathered
    weights) and remat (the recomputation re-issues the forward's gathers)
    on the 1×2 grid against the same path in one process;
  * the collectives a step makes, by axis and kind;
  * ``make_grid``'s refusals (d·m != world, an unknown axis);
  * (slow) the grids against JAX's own (data 4, model 2) ``param_shardings``
    run, built as ``tests/test_sharding.py`` builds it.

One spawn a grid, both in one module fixture; the ranks import no JAX."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.parallel import (  # noqa: E402
    DataGroup,
    Grid,
    ModelGroup,
    gather_encoder_params,
    gather_split,
    make_grid,
    partition_encoder,
    shard_batch,
)
from speech_decoding_tpu_torch.parallel.collectives import calls, tensors_digest  # noqa: E402
from speech_decoding_tpu_torch.parallel.multihost import spawn_ranks  # noqa: E402
from speech_decoding_tpu_torch.training import create_train_state, make_eval_step, make_train_step  # noqa: E402

torch.set_num_threads(1)

S, D1, D2, F, K, C, T, B = 2, 16, 24, 32, 4, 208, 24, 8
LR, STEPS, MIN_DIM = 1e-3, 4, 16
GRIDS = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2}}
PATHS = {"module": ("gemm", False, False), "pallas_taps": ("pallas_taps", False, False),
         "fused": ("gemm", True, False), "remat": ("gemm", False, True)}
GRID_PATHS = {"1x2": tuple(PATHS), "2x2": ("module",)}
# the collectives of one step on a grid with every tensor of the rule split:
# the data axis as without a grid (20 BN sums, 7 in the CLIP loss and its
# top-k, 1 gradient all-reduce); on the model axis, module path: an
# all-gather a split layer's output (19: the subject conv and kernel, 15
# block convs, 2 heads) and an all-reduce a split layer's input gradient
# (19) plus the spatial attention's logits; K5 and K6 gather their 15
# kernels and leave their convs' inputs whole; remat re-gathers the 15
# block convs' outputs in the recomputation
DATA_AXIS_CALLS = {"data.all_reduce": 27, "data.all_gather": 1}
MODEL_AXIS_CALLS = {"module": {"model.all_reduce": 20, "model.all_gather": 19},
                    "pallas_taps": {"model.all_reduce": 5, "model.all_gather": 19},
                    "fused": {"model.all_reduce": 5, "model.all_gather": 19},
                    "remat": {"model.all_reduce": 20, "model.all_gather": 34}}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _loc():
    return ch_locations_2d("Gwilliams2022", cache=False)


def _batch():
    rng = np.random.default_rng(17)
    return {"X": (rng.normal(size=(B, C, T)) * 2).astype(np.float32),
            "Y": rng.normal(size=(B, F, T)).astype(np.float32),
            "subject_idxs": (np.arange(B) % S).astype(np.int32)}


def _encoder(conv_impl="gemm", remat=False, **dims):
    kw = dict(num_subjects=S, D1=D1, D2=D2, F=F, K=K, **dims)
    return BrainEncoder(loc=_loc(), conv_impl=conv_impl, remat=remat, generator=torch.Generator().manual_seed(0), **kw)


def _local_grid(m: int, j: int = 0) -> Grid:
    """A grid record for partitioning alone (no process group, no
    collective): model rank j of m."""
    cpu = torch.device("cpu")
    return Grid(data=DataGroup(1, 0, cpu), model=ModelGroup(m, j, cpu))


# -- what each rank (or one process, grid None) computes ----------------------------------------


def _run(shape, path, sd, masks):
    """An eval of the state ``sd``, then STEPS train steps from it on the
    batch (its data block on a grid): losses, the first step's gradients
    (whole), the running statistics, each step's collectives and the
    gathered state's digest."""
    impl, fused, remat = PATHS[path]
    enc = _encoder(impl, remat)
    enc.load_state_dict({k: _t(v) for k, v in sd.items()})
    grid = None
    out = {}
    if shape is not None:
        grid = make_grid(shape, "cpu")
        partition_encoder(enc, grid, MIN_DIM)
        out["round_trip"] = all(torch.equal(v, _t(sd[k])) for k, v in gather_encoder_params(enc).items())
    st = create_train_state(enc, lr=LR, device="cpu", group=grid)
    step = make_train_step(fused_blocks=fused, group=grid)
    b = {k: _t(v) for k, v in _batch().items()}
    local = b if grid is None else shard_batch(b, grid.data)
    out["eval"] = {k: float(v) for k, v in make_eval_step()(st, b).items()}
    with torch.no_grad():
        out["eval"]["Z"] = _np(st.encoder(b["X"], b["subject_idxs"]))
    out.update(losses=[], collectives=[])
    for i in range(STEPS):
        before = dict(calls)
        st, m = step(st, local, drop_mask=_t(masks[i]))
        out["collectives"].append({k: v - before.get(k, 0) for k, v in calls.items() if v - before.get(k, 0)})
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["grads"] = {n: _np(g) for n, g in gather_split(
                st.encoder, {n: p.grad for n, p in st.encoder.named_parameters()}).items()}
            out["grads"]["clip.temp"] = _np(st.clip.temp.grad)
    out["stats"] = {n: _np(v) for n, v in st.encoder.named_buffers() if n.endswith(("mean", "var"))}
    whole = gather_encoder_params(st.encoder) if grid is not None else st.encoder.state_dict()
    out["digest"] = tensors_digest([*whole.values(), st.clip.temp]).hex()
    return out


def _refusals():
    out = []
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 3}, {"data": 2, "pipe": 1}):
        try:
            make_grid(shape, "cpu")
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    return out


def _rank(label, sd, masks):
    import torch.distributed as dist

    out = {"rank": dist.get_rank(), "refusals": _refusals() if label == "1x2" else None}
    grid = make_grid(GRIDS[label], "cpu")
    out["indices"] = (grid.data.rank, grid.model.rank, grid.data.world, grid.model.world)
    out["runs"] = {path: _run(GRIDS[label], path, sd, masks) for path in GRID_PATHS[label]}
    return out


# -- the references -------------------------------------------------------------------------------


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


def _jax_refs():
    """JAX's initial state (in the port's layout), the drop masks its step
    draws, the first step's one-device gradients and the loss trajectory."""
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.models import BrainEncoder as JaxEncoder
    from speech_decoding_tpu.models.loss import clip_loss as j_clip_loss
    from speech_decoding_tpu.training import create_train_state as j_create, make_train_step as j_make_step
    from speech_decoding_tpu_torch.models.params_bridge import load_flax_train

    enc = JaxEncoder(num_subjects=S, loc=_loc(), D1=D1, D2=D2, F=F, K=K)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    jst = j_create(enc, jax.random.PRNGKey(0), jb["X"], jb["subject_idxs"], lr=LR)
    port = _encoder()
    clip_ = create_train_state(port, device="cpu").clip
    load_flax_train(port, clip_, jax.tree.map(np.asarray, jst.params), jax.tree.map(np.asarray, jst.batch_stats))
    base_key = jax.random.PRNGKey(3)

    @jax.jit
    def drop_mask(params, stats, key):
        _, mut = enc.apply({"params": params["encoder"], "batch_stats": stats}, jb["X"], jb["subject_idxs"],
                           train=True, mutable=["batch_stats", "intermediates"], rngs={"dropout": key})
        return mut["intermediates"]["subject_block"]["spatial_attention"]["drop_mask"][0]

    masks = [np.asarray(drop_mask(jst.params, jst.batch_stats, jax.random.fold_in(base_key, i))) for i in range(STEPS)]

    @jax.jit
    def grads(params):
        def loss_fn(p):
            Z, _ = enc.apply({"params": p["encoder"], "batch_stats": jst.batch_stats}, jb["X"], jb["subject_idxs"],
                             train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.fold_in(base_key, 0)})
            return j_clip_loss(jb["Y"], Z, p["clip"]["temp"][0])

        return jax.grad(loss_fn)(params)

    ref = {"sd": {k: _np(v) for k, v in port.state_dict().items()}, "masks": masks,
           "grads": _flat_params(jax.tree.map(np.asarray, grads(jst.params)))}
    step, st, losses = j_make_step(enc, donate=False), jst, []
    for _ in range(STEPS):
        st, m = step(st, jb, base_key)
        losses.append(float(m["loss"]))
    ref["losses"] = losses
    return ref


@pytest.fixture(scope="module")
def runs():
    """The 1×2 and 2×2 grids (spawned together once JAX's initial state
    and masks exist, running while the one process computes its runs),
    JAX's references and the one-process runs of every path."""
    from concurrent.futures import ThreadPoolExecutor

    jref = _jax_refs()
    with ThreadPoolExecutor(len(GRIDS)) as ex:
        ranks = {label: ex.submit(spawn_ranks, _rank, shape["data"] * shape["model"], (label, jref["sd"], jref["masks"]),
                                  torch_threads=1, timeout=300) for label, shape in GRIDS.items()}
        one = {path: _run(None, path, jref["sd"], jref["masks"]) for path in PATHS}
        return {"jax": jref, "one": one, **{label: f.result() for label, f in ranks.items()}}


def _stats_close(got, want, what):
    """Running statistics after STEPS steps at rtol 1e-5; the means at 2·lr
    a step before the last (ROADMAP's rule: the conv biases ahead of each
    batch-stat BN have zero gradient in exact arithmetic, and Adam turns
    the rounding noise in it into ±lr a step)."""
    for name, w in want.items():
        atol = 2 * LR * (STEPS - 1) if name.endswith("mean") else 1e-6
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=atol, err_msg=f"{what}: {name}")


def _grads_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-3, atol=1e-4, err_msg=f"{what}: {name}")


# -- the rule ---------------------------------------------------------------------------------------


def _jax_split_names(params_shapes, m, min_dim):
    """Port names of the leaves JAX's ``param_shardings`` splits, on a
    (8/m, m) mesh of the conftest's devices."""
    import jax
    from jax.sharding import PartitionSpec as P

    from speech_decoding_tpu.parallel import make_mesh
    from speech_decoding_tpu.parallel.sharding_rules import param_shardings as j_param_shardings

    specs = j_param_shardings(params_shapes, make_mesh({"data": 8 // m, "model": m}), min_dim=min_dim)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: hasattr(s, "spec"))[0]
    names = {".".join(str(getattr(k, "key", k)) for k in path) for path, s in flat if s.spec != P()}
    return {n.removeprefix("encoder.") for n in names}


def _check_partition(enc, jax_split, m, min_dim, want_n):
    """Partition ``enc`` as model rank m - 1 of m: the split names equal
    JAX's, each split parameter keeps its column block and the spatial
    attention its bases' rows; the rest stays whole; a second partition
    raises."""
    whole = {n: p.detach().clone() for n, p in enc.named_parameters()}
    sa = enc.subject_block.spatial_attention
    bases = (sa.cos_b.clone(), sa.sin_b.clone())
    j = m - 1
    specs = partition_encoder(enc, _local_grid(m, j), min_dim)
    split = {n for n, s in specs.items() if s}
    assert split == jax_split and len(split) == want_n, sorted(split ^ jax_split)
    for n, p in enc.named_parameters():
        w = whole[n]
        if n in split:
            c = w.shape[-1] // m
            assert specs[n] == (None,) * (w.ndim - 1) + ("model",)
            assert torch.equal(p, w[..., j * c : (j + 1) * c]), n
        else:
            assert specs[n] == () and torch.equal(p, w), n
    if "subject_block.spatial_attention.z_re" in split:
        c = sa.z_re.shape[-1]
        assert torch.equal(sa.cos_b, bases[0][j * c : (j + 1) * c]) and torch.equal(sa.sin_b, bases[1][j * c : (j + 1) * c])
    with pytest.raises(ValueError, match="partitioned already"):
        partition_encoder(enc, _local_grid(m, j), min_dim)


def _jax_tree_shapes(**dims):
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.models import BrainEncoder as JaxEncoder

    jenc = JaxEncoder(loc=_loc(), **dims)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.zeros((2, C, T)), jnp.zeros((2,), jnp.int32))
    return {"encoder": shapes["params"], "clip": {"temp": jax.ShapeDtypeStruct((1,), jnp.float32)}}


@pytest.mark.parametrize("min_dim,want_n", [(16, 21), (32, 7)])
def test_partition_splits_the_leaves_param_shardings_splits_tiny(min_dim, want_n):
    """The tiny tree at m=2: every ndim >= 2 leaf at min_dim 16; at 32 only
    the conv2 kernels (48 columns) and the heads (48 and 32)."""
    tree = _jax_tree_shapes(num_subjects=S, D1=D1, D2=D2, F=F, K=K)
    _check_partition(_encoder(), _jax_split_names(tree, 2, min_dim), 2, min_dim, want_n)


@pytest.mark.parametrize("m,want_n", [(2, 21), (4, 19)])
def test_partition_splits_the_leaves_param_shardings_splits_flagship(m, want_n):
    """The flagship's shapes (S 27, D1 270, D2 320, F 1024, K 32) at min_dim
    64, 21 of the train state's 60 leaves at m=2; at m=4 the subject conv
    and the subject kernel (270 columns, 270 % 4 != 0) stay whole."""
    import jax

    dims = dict(num_subjects=27, D1=270, D2=320, F=1024, K=32)
    tree = _jax_tree_shapes(**dims)
    assert len(jax.tree.leaves(tree)) == 60
    enc = BrainEncoder(loc=_loc(), generator=torch.Generator().manual_seed(0), **dims)
    _check_partition(enc, _jax_split_names(tree, m, 64), m, 64, want_n)


# -- the grids against one process and JAX ---------------------------------------------------------


@pytest.mark.parametrize("label", list(GRIDS))
def test_grid_gradients_match_one_process_and_jax(runs, label):
    """The first step's gradients on every rank, summed over the data axis
    and gathered over the model axis, against the one-process step and JAX's
    one-device gradients: rtol 1e-3, atol 1e-4."""
    for r in runs[label]:
        got = r["runs"]["module"]["grads"]
        _grads_close(got, runs["one"]["module"]["grads"], f"{label} rank {r['rank']} vs one process")
        _grads_close(got, runs["jax"]["grads"], f"{label} rank {r['rank']} vs JAX")
    _grads_close(runs["one"]["module"]["grads"], runs["jax"]["grads"], "one process vs JAX")


@pytest.mark.parametrize("label", list(GRIDS))
def test_grid_loss_trajectory_matches_one_process_and_jax(runs, label):
    """Four Adam steps: each step's loss at rtol 1e-5, atol 1e-6 against one
    process and JAX."""
    for r in runs[label]:
        got = r["runs"]["module"]["losses"]
        np.testing.assert_allclose(got, runs["one"]["module"]["losses"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, runs["jax"]["losses"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("label", list(GRIDS))
def test_grid_statistics_eval_and_state_match(runs, label):
    """The eval forward and step on the grid before training (the model
    ranks together, every rank the whole batch) against one process's: Z at
    1e-5 of its largest entry, the loss at rtol 1e-5, top-k within one
    segment (the initial weights leave near-ties); after four steps the running statistics (``_stats_close``)
    against one process, and every rank's gathered state (parameters,
    statistics, temperature) identical; partition then gather gives the
    loaded state back bit for bit."""
    one = runs["one"]["module"]
    digests = set()
    for r in runs[label]:
        got = r["runs"]["module"]
        _stats_close(got["stats"], one["stats"], f"{label} rank {r['rank']}")
        want = one["eval"]["Z"]
        np.testing.assert_allclose(got["eval"]["Z"], want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
        assert got["eval"]["loss"] == pytest.approx(one["eval"]["loss"], rel=1e-5)
        for k in ("top1", "top10"):
            assert abs(got["eval"][k] - one["eval"][k]) <= 1 / B + 1e-7, k
        assert got["round_trip"]
        digests.add(got["digest"])
    assert len(digests) == 1


@pytest.mark.parametrize("label", list(GRIDS))
def test_grid_layout_is_jax_reshape(runs, label):
    """Rank r has data index r // m and model index r % m (JAX's
    ``reshape(d, m)``)."""
    d, m = GRIDS[label]["data"], GRIDS[label]["model"]
    assert [r["indices"] for r in runs[label]] == [(r // m, r % m, d, m) for r in range(d * m)]


@pytest.mark.parametrize("path", ["pallas_taps", "fused", "remat"])
def test_grid_paths_match_one_process(runs, path):
    """K5 and K6 on whole weights gathered over the model axis, and remat
    (its recomputation re-issues the forward's gathers), on the 1×2 grid:
    the first step's gradients against the same path in one process and
    JAX's (rtol 1e-3, atol 1e-4), the losses at rtol 1e-5, the running
    statistics (``_stats_close``)."""
    one = runs["one"][path]
    _grads_close(one["grads"], runs["jax"]["grads"], f"{path} one process vs JAX")
    for r in runs["1x2"]:
        got = r["runs"][path]
        _grads_close(got["grads"], one["grads"], f"{path} rank {r['rank']} vs one process")
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5, atol=1e-6)
        _stats_close(got["stats"], one["stats"], f"{path} rank {r['rank']}")


@pytest.mark.parametrize("path", list(PATHS))
def test_collectives_per_step_by_axis(runs, path):
    """Every step of every rank makes the data axis's 28 collectives and its
    path's model-axis ones; one process makes none."""
    want = {**DATA_AXIS_CALLS, **MODEL_AXIS_CALLS[path]}
    for label in GRIDS:
        if path not in GRID_PATHS[label]:
            continue
        for r in runs[label]:
            assert r["runs"][path]["collectives"] == [want] * STEPS, (label, r["rank"])
    assert runs["one"][path]["collectives"] == [{}] * STEPS


def test_make_grid_refusals(runs):
    """d·m must equal the world size, and the axes are "data" and "model"."""
    for r in runs["1x2"]:
        assert r["refusals"] == ["mesh 2x2 != 2 processes", "mesh 1x3 != 2 processes",
                                 "mesh_shape names unknown axes ['pipe']"]


def test_make_grid_needs_a_process_group():
    with pytest.raises(RuntimeError, match="not initialized"):
        make_grid({"data": 1, "model": 1}, "cpu")


# -- against JAX's own tensor-parallel run ---------------------------------------------------------


@pytest.mark.slow  # JAX's (data 4, model 2) GSPMD run: tests/test_sharding.py's slow TP test
def test_grids_match_jax_param_shardings_run(runs):
    """JAX's train step on a (data 4, model 2) mesh with its parameters
    placed by ``param_shardings`` (min_dim 16) and the batch sharded over
    "data", as ``tests/test_sharding.py::test_tp_train_steps_match_replicated``
    builds it: its first step's gradients (rtol 1e-3, atol 1e-4) and its
    four-step loss trajectory (rtol 1e-5, atol 1e-6) against both grids."""
    import jax
    import jax.numpy as jnp

    from speech_decoding_tpu.models import BrainEncoder as JaxEncoder
    from speech_decoding_tpu.models.loss import clip_loss as j_clip_loss
    from speech_decoding_tpu.parallel import make_mesh, shard_batch as j_shard_batch
    from speech_decoding_tpu.parallel.mesh import replicated
    from speech_decoding_tpu.parallel.sharding_rules import param_shardings as j_param_shardings
    from speech_decoding_tpu.training import create_train_state as j_create, make_train_step as j_make_step

    mesh = make_mesh({"data": 4, "model": 2})
    enc = JaxEncoder(num_subjects=S, loc=_loc(), D1=D1, D2=D2, F=F, K=K)
    b = _batch()
    st = j_create(enc, jax.random.PRNGKey(0), jnp.asarray(b["X"]), jnp.asarray(b["subject_idxs"]), lr=LR)
    st = st.replace(params=jax.tree.map(jax.device_put, st.params, j_param_shardings(st.params, mesh, min_dim=16)),
                    batch_stats=jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), st.batch_stats))
    jb = j_shard_batch(b, mesh)
    base_key = jax.random.PRNGKey(3)

    @jax.jit
    def grads(params, batch_stats, batch):
        def loss_fn(p):
            Z, _ = enc.apply({"params": p["encoder"], "batch_stats": batch_stats}, batch["X"], batch["subject_idxs"],
                             train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.fold_in(base_key, 0)})
            return j_clip_loss(batch["Y"], Z, p["clip"]["temp"][0])

        return jax.grad(loss_fn)(params)

    tp_grads = _flat_params(jax.tree.map(np.asarray, grads(st.params, st.batch_stats, jb)))
    step, losses = j_make_step(enc, donate=False), []
    for _ in range(STEPS):
        st, m = step(st, jb, base_key)
        losses.append(float(m["loss"]))
    for label in GRIDS:
        for r in runs[label]:
            _grads_close(r["runs"]["module"]["grads"], tp_grads, f"{label} rank {r['rank']} vs JAX's TP run")
            np.testing.assert_allclose(r["runs"]["module"]["losses"], losses, rtol=1e-5, atol=1e-6)
