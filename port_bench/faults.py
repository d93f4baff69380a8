"""Faults planted under the program's timed path, for the check of the
comparison: each must make ``correct`` come out false. A fault is called
with the program's trainer after set-up has built it and before its first
step."""

from __future__ import annotations


def state_unchanged(trainer) -> None:
    """Every optimizer update returns the state as it was."""
    opt = trainer.state.optimizer
    adam = getattr(opt, "optimizer", opt)
    adam.step = lambda *a, **k: None


def half_batch(trainer) -> None:
    """Each step trains on the first half of its batch: the loss is the
    mean over the rest."""
    step, scan = trainer.train_step, trainer.train_step_scan

    def cut(state, batch, *a, **k):
        h = batch["X"].shape[0] // 2
        return step(state, {n: v[:h] for n, v in batch.items()}, *a, **k)

    def cut_scan(state, batches, *a, **k):
        h = batches["X"].shape[1] // 2
        return scan(state, {n: v[:, :h] for n, v in batches.items()}, *a, **k)

    trainer.train_step = cut
    if scan is not None:
        trainer.train_step_scan = cut_scan
