"""Standalone evaluation: restore a trained model and run the full-test-set
retrieval eval (loss, top-1, top-10) without training.

Port of the JAX package's ``tools/evaluate.py``. The reference has no eval
entry point: its metrics exist only inside train.py's epoch loop
[ref: train.py:211-243].

    # the latest (or best, or a given epoch's) checkpoint of a port run
    python -m speech_decoding_tpu_torch.tools.evaluate outputs/<run>/config.yaml \
        checkpoint.dir=outputs/<run>/checkpoints [eval.best=true] [eval.epoch=N]

    # a reference-trained torch checkpoint
    python -m speech_decoding_tpu_torch.tools.evaluate dataset=Gwilliams2022 torch_checkpoint=model_last.pt

The datasets, the split pools and the fixed test batch are rebuilt as
``speech_decoding_tpu_torch.train`` builds them (the same seed
derivations), so the printed metrics are the "testTop10acc" a training run
reports at that checkpoint. The eval runs in the layout the run trained in
(``train.resolve_channels_last``), so on the card it repeats the
training-time eval's arithmetic. Prints one JSON line. Runs on the card
(``evaluate(args, device=None)``: ``cuda`` unless ``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np
import torch


def evaluate(args, device=None) -> Dict:
    from speech_decoding_tpu_torch import train as train_cli
    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.data.sampling import random_split
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
    from speech_decoding_tpu_torch.training.state import create_train_state
    from speech_decoding_tpu_torch.training.steps import make_chunked_eval, make_eval_step
    from speech_decoding_tpu_torch.utils.device import resolve_device
    from speech_decoding_tpu_torch.utils.logging import cprint
    from speech_decoding_tpu_torch.utils.reproducibility import seed_everything

    dev = resolve_device(device)
    # the training run's RECORDED seed first (train.run writes
    # ``resolved_seed`` into its config snapshot): with the reference-parity
    # default ``reproducible: false`` the split pools are a function of the
    # seed the run drew, not of the config's ``seed``
    seed = args.select("resolved_seed", None)
    if seed is None:
        # without a recorded seed a reproducible=false run's split cannot be
        # rebuilt; re-drawing one would leak trained segments into the
        # "test" batch
        if not bool(args.get("reproducible", True)):
            raise ValueError(
                "this config has reproducible=false and no recorded resolved_seed: the training run's "
                "train/test split cannot be rebuilt (a re-drawn split would leak training segments into "
                "'test'). Pass the run dir's config snapshot or an explicit resolved_seed=N override.")
        seed = args.get("seed", 0)
    seed = int(seed)
    # the global rngs too: the legacy sentence split shuffles with np.random
    seed_everything(seed)
    rng = np.random.default_rng(seed)

    collate, channels_last = None, False
    if args.dataset == "Gwilliams2022":
        _train_set, test_set, _train_pool, test_pool = train_cli.build_gwilliams(args, rng, dev)
        channels_last = train_cli.resolve_channels_last(args)
        collate = train_cli.build_collate(args)
    elif args.dataset == "Brennan2018":
        from speech_decoding_tpu_torch.data.brennan2018 import Brennan2018Dataset

        test_set = Brennan2018Dataset(args, device=dev)
        _train_pool, test_pool = random_split(len(test_set), args.split_ratio, rng)
    else:
        raise ValueError("Unknown dataset")
    args.set_path("tpu.channels_last_io", channels_last)  # Brennan batches are channels-first
    num_subjects = test_set.num_subjects

    loc = ch_locations_2d(args.dataset, args.root_dir)
    torch_ckpt = args.select("torch_checkpoint", None)
    if torch_ckpt:
        # reference checkpoints carry encoder weights only [ref: train.py:259];
        # the encoder computes in f32, as the JAX tool builds it
        from speech_decoding_tpu_torch.models.params_bridge import load_flax
        from speech_decoding_tpu_torch.models.torch_port import brain_encoder_from_torch

        sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
        params, batch_stats, dims = brain_encoder_from_torch(sd)
        if dims["S"] != num_subjects:
            raise ValueError(f"checkpoint has {dims['S']} subjects, dataset has {num_subjects}")
        encoder = BrainEncoder(num_subjects=dims["S"], loc=loc, D1=dims["D1"], D2=dims["D2"], F=dims["F"],
                               K=dims["K"], d_drop=float(args.get("d_drop", 0.1)), compute_dtype=torch.float32,
                               channels_last_io=channels_last)
        load_flax(encoder, params, batch_stats)
        state = create_train_state(encoder, init_temperature=float(args.init_temperature), device=dev)
        restored_from = {"torch_checkpoint": torch_ckpt, "epoch": None}
    else:
        ckpt_dir = args.select("checkpoint.dir", None)
        if not ckpt_dir:
            raise ValueError("pass checkpoint.dir=... or torch_checkpoint=...")
        if not os.path.isabs(ckpt_dir):
            ckpt_dir = os.path.join(args.root_dir, ckpt_dir)
        state = create_train_state(BrainEncoder.from_config(args, loc, num_subjects),
                                   init_temperature=float(args.init_temperature), device=dev)
        best = bool(args.select("eval.best", False))
        mgr = CheckpointManager(
            ckpt_dir, track_metric=(args.select("checkpoint.track_metric", "testTop10acc") or None) if best else None)
        epoch = args.select("eval.epoch", None)
        # parameters and statistics only: the optimizer state's shape
        # depends on the training wiring (MultiSteps for Brennan) and eval
        # never needs it
        state, epoch = mgr.restore_for_eval(state, epoch=int(epoch) if epoch is not None else None, best=best)
        restored_from = {"checkpoint_dir": ckpt_dir, "epoch": int(epoch), "best": best}

    # the fixed test batch train.run evaluates each epoch (seed + 1); with
    # tpu.redraw_test_batch, epoch N > 0 evaluates on seed + 1 + 1000 N.
    # Torch checkpoints carry no epoch: the unsalted batch stands
    epoch_n = restored_from.get("epoch")
    salt = 1000 * int(epoch_n) if bool(args.select("tpu.redraw_test_batch", False)) and epoch_n else 0
    batch = test_set.sample_batch(np.random.default_rng(seed + 1 + salt), test_pool)
    B_test = batch["X"].shape[0]

    chunk = int(args.select("tpu.eval_chunk_size", 1024))
    if 0 < chunk < B_test:
        eval_fn = make_chunked_eval(args.reduction, collate, chunk_size=chunk)
    else:
        eval_fn = make_eval_step(args.reduction, collate)
    dev_batch = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k == "subject_idxs":  # the per-subject kernel reads them on the host
            dev_batch[k] = t.to(torch.int32)
            continue
        if channels_last and k in ("X", "Y"):
            t = t.transpose(1, 2)
        dev_batch[k] = t.to(dev).contiguous()
    ev = eval_fn(state, dev_batch)
    ev = dict(zip(ev, torch.stack([v.float() for v in ev.values()]).cpu().tolist()))

    out = {
        "dataset": args.dataset,
        "test_segments": int(B_test),
        "test_loss": ev["loss"],
        "testTop1acc": ev["top1"],
        "testTop10acc": ev["top10"],
        **restored_from,
    }
    cprint(f"eval | {args.dataset} B={B_test} | loss {ev['loss']:.4f} | top1 {ev['top1']:.4f} | "
           f"top10 {ev['top10']:.4f}", "cyan")
    return out


def main(argv=None) -> None:
    from speech_decoding_tpu_torch.train import parse_argv

    print(json.dumps(evaluate(parse_argv(sys.argv[1:] if argv is None else list(argv)))))


if __name__ == "__main__":
    main()
