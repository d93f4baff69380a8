"""The port's Trainer against the JAX package's, in f32 on the CPU: the same
config, the same numpy batches (2 epochs of 3 batches and a test batch),
the port's encoder loaded through ``models/params_bridge.py`` from the JAX
Trainer's initial parameters. B=6 is not a multiple of the 8 CPU devices
that tests/conftest.py forces, so the JAX Trainer builds no mesh. The
encoders have ``d_drop=0.0``: neither side drops a sensor, since the two
frameworks draw different dropout centres.

The learning rate is small (5e-7) for a measured reason. Adam's first
update is ±lr whatever the gradient's size, so an entry whose gradient lies
below the two frameworks' f32 summation noise (about 2e-5 of the largest
gradient) may step in opposite directions on the two sides: the
zero-gradient conv biases, and at lr 1e-3 also one conv kernel entry, which
moved the later train losses apart by 2e-4 relative. The eval loss sees the
biases too, through running means that lag them. Both effects scale with lr
(at 2e-6 the test loss was already 1.6e-5 apart), and at 5e-7 they stay
under the 1e-5 tolerance; the updates themselves move each epoch's train
loss by 2.8e-5 to 4.5e-5 relative there (measured against lr 0), so a
missing update still fails. The optimizer's arithmetic at lr 1e-3 is held
by tests/test_torch_train.py; here the point is the loop: batches, scan
groups, forward-only steps, eval and the running statistics (whose order
the test loss sees)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.config import load_config as j_load_config  # noqa: E402
from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import flax_train_from_state, load_flax  # noqa: E402
from speech_decoding_tpu_torch.training import Trainer  # noqa: E402

torch.set_num_threads(1)

S, D1, D2, F, K, B, T, C = 2, 8, 8, 16, 2, 6, 24, 208
LR = 5e-7
KW = dict(num_subjects=S, D1=D1, D2=D2, F=F, K=K, d_drop=0.0)


def _batches(n, seed, b=B):
    rng = np.random.default_rng(seed)
    return [{"X": rng.normal(size=(b, C, T)).astype(np.float32), "Y": rng.normal(size=(b, F, T)).astype(np.float32),
             "subject_idxs": rng.integers(0, S, b).astype(np.int32)} for _ in range(n)]


def _overrides(scan_steps, legacy):
    return {"tpu.compute_dtype": "float32", "tpu.scan_steps": scan_steps, "tpu.brennan_legacy_accumulation": legacy,
            "lr": LR, "epochs": 2}


def _zero_grad_entries(name):
    """Entries whose gradient is zero in exact arithmetic, so both sides hold
    rounding noise that Adam turns into ±lr steps (tests/test_torch_train.py):
    the conv0/conv1 biases of a ConvBlock and z_re[:, 0]."""
    parts = name.split(".")
    if parts[-1] == "bias" and parts[-2] in ("conv0", "conv1") and parts[-3].startswith("conv"):
        return np.s_[...]
    if parts[-1] == "z_re":
        return np.s_[:, 0]
    return None


def _warm_stats(jtr, batch, calls=40):
    """BatchNorm running statistics moved (momentum 0.1 a call) onto the
    train-mode statistics of ``batch``. From the initial (0, 1) statistics
    this small encoder maps every test segment to nearly the same eval
    embedding (spread 1e-6), so every retrieval rank would be a near-tie."""
    fwd = jax.jit(lambda stats: jtr.encoder.apply(
        {"params": jtr.state.params["encoder"], "batch_stats": stats}, batch["X"], batch["subject_idxs"],
        train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})[1]["batch_stats"])
    stats = jtr.state.batch_stats
    for _ in range(calls):
        stats = fwd(stats)
    return stats


def _run_both(scan_steps, legacy, epochs):
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    jcfg, tcfg = j_load_config(), load_config()
    for path, value in _overrides(scan_steps, legacy).items():
        jcfg.set_path(path, value)
        tcfg.set_path(path, value)
    data = [_batches(3, seed=ep) for ep in range(epochs)]
    test = _batches(1, seed=99, b=10)[0]
    jtr = JaxTrainer(JaxEncoder(loc=loc, **KW), jcfg, data[0][0])
    assert jtr.mesh is None
    jtr.state = jtr.state.replace(batch_stats=_warm_stats(jtr, data[0][0]))
    params = jax.tree.map(np.asarray, jtr.state.params)
    enc = load_flax(BrainEncoder(loc=loc, **KW), params["encoder"], jax.tree.map(np.asarray, jtr.state.batch_stats))
    ttr = Trainer(enc, tcfg, data[0][0], device="cpu")
    for ep in range(epochs):
        jtr.run_epoch(ep, [dict(b) for b in data[ep]], test)
        ttr.run_epoch(ep, [dict(b) for b in data[ep]], test)
    return jtr, ttr


def _compare(jtr, ttr, steps):
    """history: losses and temperature at rtol 1e-5, top-k exactly; final
    parameters: the zero-gradient entries within 2·LR a step, every other
    entry within 1e-5."""
    assert len(jtr.history) == len(ttr.history)
    for jh, th in zip(jtr.history, ttr.history):
        assert set(jh) == set(th)
        for k in ("train_loss", "test_loss", "temp"):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, err_msg=k)
        for k in ("trainTop1acc", "trainTop10acc", "testTop1acc", "testTop10acc"):
            assert th[k] == jh[k], k
    assert ttr.state.step == int(jtr.state.step) == steps
    got, _ = flax_train_from_state(ttr.state.encoder, ttr.state.clip)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jtr.state.params))[0]:
        g = got
        for p in path:
            g = g[p.key]
        name = ".".join(p.key for p in path)
        noisy = _zero_grad_entries(name)
        if noisy is not None:
            np.testing.assert_allclose(g[noisy], leaf[noisy], rtol=0, atol=2 * LR * steps, err_msg=name)
            g, leaf = g.copy(), leaf.copy()
            g[noisy] = leaf[noisy] = 0
        np.testing.assert_allclose(g, leaf, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_trainer_matches_jax(scan_steps):
    """scan_steps 1 (one step a dispatch) and 2 (a scanned pair, then the
    remainder alone): 6 optimizer steps over 2 epochs, eval each epoch."""
    jtr, ttr = _run_both(scan_steps, legacy=False, epochs=2)
    _compare(jtr, ttr, steps=6)


def test_trainer_legacy_accumulation_matches_jax():
    """brennan_legacy_accumulation: the first two batches run forward only
    (running statistics move, parameters do not), the last one steps:
    step == 1 after the epoch."""
    jtr, ttr = _run_both(1, legacy=True, epochs=1)
    _compare(jtr, ttr, steps=1)
