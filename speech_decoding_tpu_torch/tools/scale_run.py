"""Scale-validation run: the port's Trainer at flagship width on a synthetic
world that can be learned, so throughput and learning dynamics are checked
on the card without a dataset.

Port of the JAX package's ``tools/scale_run.py``. Segments come from a
fixed random linear-map world: X standard normal per segment, Y = tanh(X A)
for a frozen A (C, F), channels-last. The encoder has to learn the map, so
held-out top-10 above chance shows end-to-end training, not just step
mechanics. The pool of ``train_pool`` + 64 held-out segments lives on the
device in bf16 (about 0.5 GB at 512 + 64 flagship segments) and each batch
is gathered from it by index on the device: a step moves no segment data
from the host. Flagship width: B=64, C=208, T=360, F=1024, 27 subjects,
D1=270, D2=320, K=32, bf16, channels-last, ``tpu.conv_impl=gemm_pdw``,
``tpu.scan_steps`` 8, lr 3e-4.

    python -m speech_decoding_tpu_torch.tools.scale_run [epochs] [updates] [train_pool]

It prints one JSON summary (held-out top-10 against chance, the learning
gate, steady segments/s, wall time) and writes no file.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from speech_decoding_tpu_torch.config import Config, load_config
from speech_decoding_tpu_torch.data.layout import ch_locations_2d
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
from speech_decoding_tpu_torch.training.trainer import Trainer
from speech_decoding_tpu_torch.utils.device import resolve_device

FLAGSHIP = {"B": 64, "C": 208, "T": 360, "F": 1024, "S": 27, "D1": 270, "D2": 320, "K": 32}
N_TEST = 64


class World:
    """The device-resident segment pool: X (N, T, C) and Y = tanh(X A) (N, T,
    F), both bf16, the first ``n_train`` rows for training and the last
    ``N_TEST`` held out."""

    def __init__(self, n_train: int, dims: Dict[str, int], device, seed: int = 0):
        g = torch.Generator(device=device).manual_seed(seed)
        C, T, F = dims["C"], dims["T"], dims["F"]
        self.n_train, self.S, self.B = n_train, dims["S"], dims["B"]
        self.X = torch.randn(n_train + N_TEST, T, C, generator=g, device=device).to(torch.bfloat16)
        A = (torch.randn(C, F, generator=g, device=device) / math.sqrt(C)).to(torch.bfloat16)
        self.Y = torch.tanh(self.X @ A)

    def batch(self, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        """The segments ``ids``, gathered on the device; subject ids (ids mod
        S) stay on the host."""
        idx = torch.from_numpy(np.asarray(ids, np.int64)).to(self.X.device)
        return {"X": self.X[idx], "Y": self.Y[idx], "subject_idxs": torch.from_numpy((ids % self.S).astype(np.int32))}

    def test_batch(self) -> Dict[str, torch.Tensor]:
        return self.batch(np.arange(self.n_train, self.n_train + N_TEST))

    def train_batches(self, rng: np.random.Generator, updates: int) -> Iterator[Dict[str, torch.Tensor]]:
        # unique within a batch, like the production sampler (a duplicate
        # segment would corrupt the CLIP diagonal objective)
        return (self.batch(rng.choice(self.n_train, self.B, replace=False)) for _ in range(updates))


def flagship_args(epochs: int, overrides: Sequence[str] = ()) -> Config:
    return load_config(None, ["seed=0", "reduction=mean", "init_temperature=5.1", "lr=3e-4", f"epochs={epochs}",
                              "tpu.compute_dtype=bfloat16", "tpu.conv_impl=gemm_pdw", "tpu.channels_last_io=true",
                              "tpu.scan_steps=8", *overrides])


def make_encoder(args: Config, dims: Dict[str, int], seed: int = 0) -> BrainEncoder:
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    if loc.shape[0] != dims["C"]:
        raise ValueError(f"the Gwilliams2022 layout has {loc.shape[0]} sensors, the world {dims['C']}")
    return BrainEncoder(num_subjects=dims["S"], loc=loc, D1=dims["D1"], D2=dims["D2"], F=dims["F"], K=dims["K"],
                        d_drop=float(args.d_drop), compute_dtype=getattr(torch, args.tpu.compute_dtype),
                        channels_last_io=True, generator=torch.Generator().manual_seed(seed),
                        conv_impl=str(args.tpu.conv_impl), remat=bool(args.select("tpu.remat", False)))


def learning_gate(history, n_test: int = N_TEST) -> Dict[str, bool]:
    """The gate of tests/test_learning_gate.py: held-out top-10 of the last
    epoch at least twice chance (10 / n_test), and the last train loss under
    0.9 of the first."""
    return {"heldout_top10_over_2x_chance": history[-1]["testTop10acc"] >= 2.0 * 10 / n_test,
            "train_loss_fell_10pct": history[-1]["train_loss"] < 0.9 * history[0]["train_loss"]}


def run(epochs: int = 5, updates: int = 100, train_pool: int = 256, device=None,
        checkpoints: Optional[CheckpointManager] = None, dims: Optional[Dict[str, int]] = None,
        world: Optional[World] = None, seed: int = 0):
    """The scale run. Returns (summary dict, trainer, world); the trainer and
    the world stay usable (resume, serving). ``dims`` cuts the widths (the
    CPU tests); ``world`` reuses a pool."""
    dev = resolve_device(device)
    dims = dict(FLAGSHIP if dims is None else dims)
    world = world or World(train_pool, dims, dev, seed)
    args = flagship_args(epochs)
    trainer = Trainer(make_encoder(args, dims, seed), args, checkpoints=checkpoints, device=dev)
    test = world.test_batch()
    ep_rng = np.random.default_rng(1)
    epoch_s = []
    t0 = time.perf_counter()
    for ep in range(trainer.start_epoch, trainer.start_epoch + epochs):
        t = time.perf_counter()
        trainer.run_epoch(ep, world.train_batches(ep_rng, updates), test)
        epoch_s.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    hist = trainer.history
    steady = float(np.median([h["train_segments_per_sec"] for h in hist[1:]] or [hist[0]["train_segments_per_sec"]]))
    summary = {
        "epochs": epochs, "updates_per_epoch": updates, "batch": dims["B"], "train_pool_segments": train_pool,
        "test_segments": N_TEST, "dims": dims, "compute_dtype": str(args.tpu.compute_dtype),
        "scan_steps": int(args.tpu.scan_steps), "fused_train_blocks": bool(args.select("tpu.fused_train_blocks")),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "testTop10_first_epoch": hist[0]["testTop10acc"], "testTop10_last_epoch": hist[-1]["testTop10acc"],
        "chance_top10": 10 / N_TEST, "train_loss_first_epoch": hist[0]["train_loss"],
        "train_loss_last_epoch": hist[-1]["train_loss"], "gate": learning_gate(hist),
        "steady_segments_per_sec": steady, "steady_steps_per_sec": steady / dims["B"],
        "epoch_seconds": epoch_s, "eval_seconds": trainer.last_epoch_seconds.get("eval"), "wall_s": wall,
        "world": "synthetic learnable Y = tanh(X A), held-out test pool",
    }
    return summary, trainer, world


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", type=int, nargs="?", default=5)
    ap.add_argument("updates", type=int, nargs="?", default=100)
    ap.add_argument("train_pool", type=int, nargs="?", default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    summary, _, _ = run(a.epochs, a.updates, a.train_pool, device=a.device)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
