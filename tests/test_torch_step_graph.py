"""The train step's CUDA-graph rule on the CPU (``training/steps.py``): which
steps may replay a graph (devices and types only, so the rule is held here
with stand-ins for card tensors), that every CPU step runs eagerly with
fresh metrics and no capture, and that the Trainer's scan step calls the
Trainer's own single step, so both share one graph. The graph against the
eager step on the card: ``tests/test_torch_step_graph_cuda.py``."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_decoding_tpu_torch.config import load_config  # noqa: E402
from speech_decoding_tpu_torch.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder, dropout_mask_at  # noqa: E402
from speech_decoding_tpu_torch.parallel.mesh import Grid  # noqa: E402
from speech_decoding_tpu_torch.training import (  # noqa: E402
    Trainer, create_train_state, make_train_step, make_train_step_scan,
)
from speech_decoding_tpu_torch.training import steps  # noqa: E402
from speech_decoding_tpu_torch.training.state import MultiSteps  # noqa: E402

S, D1, D2, F, K, B, T = 3, 8, 8, 16, 2, 6, 24
LOC = ch_locations_2d("Gwilliams2022", cache=False)
C = len(LOC)
CARD = torch.device("cuda:0")


def _encoder(remat=False):
    return BrainEncoder(num_subjects=S, loc=LOC, D1=D1, D2=D2, F=F, K=K, channels_last_io=True, remat=remat,
                        generator=torch.Generator().manual_seed(0))


def _card_case(**change):
    """(state, batch, drop_mask, fused_blocks, group) of a step the rule
    admits, with ``change`` applied: the state's and the batch's tensors
    stand in for card tensors by their ``device``."""
    enc = change.pop("encoder", _encoder())
    opt = change.pop("optimizer", torch.optim.Adam(enc.parameters(), lr=1e-3))
    state = SimpleNamespace(device=change.pop("device", CARD), encoder=enc, optimizer=opt)
    on_card = SimpleNamespace(device=CARD)
    batch = {"X": on_card, "Y": on_card, "scale_stats": on_card,
             "subject_idxs": torch.zeros(B, dtype=torch.int32)}
    batch.update(change.pop("batch", {}))
    case = {"drop_mask": torch.ones(C), "fused_blocks": False, "group": None, **change}
    return state, batch, case["drop_mask"], case["fused_blocks"], case["group"]


def test_the_rule_admits_the_module_step_on_the_card():
    assert steps._graphable(*_card_case())
    assert steps._graphable(*_card_case(drop_mask=SimpleNamespace(device=CARD)))  # a mask on the card


def _grid():
    return Grid(data=object(), model=object())  # stand-ins for the two axes


EXCLUDED = {
    "group": lambda: _card_case(group=object()),
    "grid": lambda: _card_case(group=steps._data_axis(_grid())),
    "fused": lambda: _card_case(fused_blocks=True),
    "remat": lambda: _card_case(encoder=_encoder(remat=True)),
    "multisteps": lambda: _card_case(optimizer=MultiSteps(torch.optim.Adam(_encoder().parameters()), 3)),
    "no_drop_mask": lambda: _card_case(drop_mask=None),
    "cpu_state": lambda: _card_case(device=torch.device("cpu")),
    "cpu_batch_tensor": lambda: _card_case(batch={"Y": torch.zeros(1)}),
    "ids_on_the_card": lambda: _card_case(batch={"subject_idxs": SimpleNamespace(device=CARD)}),
    "mask_on_another_card": lambda: _card_case(drop_mask=SimpleNamespace(device=torch.device("cuda:1"))),
    "numpy_batch": lambda: _card_case(batch={"X": np.zeros(1)}),
}


@pytest.mark.parametrize("path", sorted(EXCLUDED))
def test_the_rule_leaves_each_other_path_eager(path):
    assert not steps._graphable(*EXCLUDED[path]())


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"X": torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)),
             "Y": torch.from_numpy(rng.normal(size=(B, T, F)).astype(np.float32)),
             "subject_idxs": torch.from_numpy(rng.integers(0, S, B).astype(np.int32))} for _ in range(n)]


def test_cpu_steps_are_eager_with_fresh_metrics():
    """Every CPU step runs eagerly, even with a drop mask: no capture, no
    replay, and each step's metrics are tensors of their own."""
    state = create_train_state(_encoder(), lr=1e-3, device="cpu")
    step = make_train_step()
    kept = []
    for i, batch in enumerate(_host_batches(4)):
        state, m = step(state, batch, drop_mask=dropout_mask_at(LOC, i, 0.1))
        kept.append(m)
    assert (step.captures, step.replays, state.step) == (0, 0, 4)
    for k in ("loss", "top1", "top10", "temp"):
        ptrs = {m[k].data_ptr() for m in kept}
        assert len(ptrs) == len(kept), k
    losses = [float(m["loss"]) for m in kept]
    assert len(set(losses)) == len(losses) and all(np.isfinite(losses))


def test_the_scan_step_calls_the_single_step_it_is_given():
    calls = []

    def single(state, batch, generator=None, drop_mask=None):
        calls.append((batch["X"].shape, None if drop_mask is None else float(drop_mask[0])))
        return state, {"loss": batch["X"].sum()}

    scan = make_train_step_scan(single)
    stacked = {"X": torch.ones(3, 2, 5), "subject_idxs": torch.zeros(3, 2, dtype=torch.int32)}
    _, m = scan(None, stacked, drop_masks=torch.arange(3.0)[:, None].expand(3, 4))
    assert calls == [((2, 5), 0.0), ((2, 5), 1.0), ((2, 5), 2.0)]
    assert m["loss"].tolist() == [10.0, 10.0, 10.0]


def test_the_trainer_scan_shares_its_single_step(monkeypatch):
    """The Trainer's scan groups and its lone steps go through the one step
    it makes (one graph a signature on the card): 2 groups of 2 and a lone
    step all reach it."""
    from speech_decoding_tpu_torch.training import trainer as trainer_module

    made, calls = [], []

    def make_counted(*a, **k):
        step = steps.make_train_step(*a, **k)

        def counted(*sa, **sk):
            calls.append(1)
            return step(*sa, **sk)

        made.append(step)
        return counted

    monkeypatch.setattr(trainer_module, "make_train_step", make_counted)
    cfg = load_config()
    for path, value in {"tpu.compute_dtype": "float32", "tpu.scan_steps": 2, "tpu.channels_last_io": True,
                        "epochs": 1}.items():
        cfg.set_path(path, value)
    trainer = Trainer(_encoder(), cfg, device="cpu")
    trainer.run_epoch(0, _host_batches(5), None)
    assert len(made) == 1 and len(calls) == trainer.state.step == 5
    assert made[0].captures == made[0].replays == 0
