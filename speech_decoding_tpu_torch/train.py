"""CLI entry point of the port, with the JAX package's ``train.py`` surface:

    python -m speech_decoding_tpu_torch.train dataset=Gwilliams2022 split_mode=shallow
    python -m speech_decoding_tpu_torch.train dataset=Brennan2018 rebuild_dataset=True
    python -m speech_decoding_tpu_torch.train outputs/<run>/config.yaml epochs=400   # resume a run

[ref: train.py:28-263, README.md:20-25]. YAML config plus key=value
overrides (``speech_decoding_tpu_torch.config``). Dataset dispatch, sampler
semantics, the epoch loop, eval, W&B and checkpointing follow the JAX CLI;
everything runs on the card (``run(args, device=None)``: ``cuda`` unless the
caller passes ``device="cpu"``; raises without a GPU). ``root_dir`` defaults
to the repository root, where ``data/<dataset>/`` lies.

Multi-process data parallelism follows the JAX CLI, one process a card
under torchrun (``parallel/multihost.py``)::

    torchrun --nproc-per-node=4 -m speech_decoding_tpu_torch.train \
        dataset=Gwilliams2022 tpu.multihost=true checkpoint.dir=/shared/ckpt

Rank 0's seed is broadcast; every rank draws the same global batch ids and
the global batch's random session or subject choices, then keeps its own
block (``host_local_slice``), so the global batch equals the one-process
run's; the last partial batch is dropped; only the primary writes the run
dir's config and logs to W&B, and checkpoints are kept only under an
explicit shared ``checkpoint.dir``.
"""

from __future__ import annotations

import os
import sys
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch
import yaml

from speech_decoding_tpu_torch.config import load_config
from speech_decoding_tpu_torch.data.layout import ch_locations_2d
from speech_decoding_tpu_torch.data.sampling import iter_shuffled_batches, iter_updates_batches, random_split
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from speech_decoding_tpu_torch.parallel.collectives import broadcast_ints
from speech_decoding_tpu_torch.parallel.mesh import current_group
from speech_decoding_tpu_torch.parallel.multihost import host_local_slice, maybe_init_distributed
from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
from speech_decoding_tpu_torch.training.preemption import PreemptionGuard
from speech_decoding_tpu_torch.training.trainer import NoopLogger, Trainer, make_wandb_logger
from speech_decoding_tpu_torch.utils.device import resolve_device
from speech_decoding_tpu_torch.utils.logging import cprint
from speech_decoding_tpu_torch.utils.reproducibility import seed_everything

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_gwilliams(args, rng: np.random.Generator, device=None):
    """Datasets and split pools [ref: train.py:54-101]: (train_set,
    test_set, train_pool, test_pool), built on ``device``."""
    from speech_decoding_tpu_torch.data.gwilliams2022 import (
        Gwilliams2022DeepSplit,
        Gwilliams2022SentenceSplit,
        Gwilliams2022ShallowSplit,
    )

    # dataset dimensions (27 subjects x 2 sessions x 4 tasks in the real
    # MEG-MASC release [ref: gwilliams2022.py:267,283-285]); overridable for
    # subsets
    dims = dict(
        num_subjects=int(args.select("gwilliams.num_subjects", 27)),
        num_sessions=int(args.select("gwilliams.num_sessions", 2)),
        num_tasks=int(args.select("gwilliams.num_tasks", 4)),
        device=device,
    )
    if args.split_mode == "sentence":
        train_set = Gwilliams2022SentenceSplit(args, **dims)
        test_set = Gwilliams2022SentenceSplit(args, train_set.test_word_idxs_dict, **dims)
        assert train_set.num_subjects == test_set.num_subjects
        train_pool = np.arange(len(train_set))
        test_pool = np.arange(len(test_set))
    elif args.split_mode == "shallow":
        train_set = test_set = Gwilliams2022ShallowSplit(args, **dims)
        train_pool, test_pool = random_split(len(train_set), args.split_ratio, rng)
    elif args.split_mode == "deep":
        train_set = Gwilliams2022DeepSplit(args, train=True, **dims)
        test_set = Gwilliams2022DeepSplit(args, train=False, **dims)
        assert train_set.num_subjects == test_set.num_subjects
        train_pool = np.arange(len(train_set))
        test_pool = np.arange(len(test_set))
    else:
        raise ValueError(f"Unknown split_mode: {args.split_mode}")
    return train_set, test_set, train_pool, test_pool


def build_collate(args) -> Dict:
    """Gwilliams in-step collate spec (the reference's Collator semantics,
    [ref: gwilliams2022.py:653-661]), shared by ``run`` and
    ``tools/evaluate.py`` so both apply the same baseline/scale/clamp."""
    return {
        "baseline_len_samp": int(args.preprocs["brain_resample_rate"] * args.preprocs["baseline_len_sec"]),
        "clamp_lim": float(args.preprocs["clamp_lim"]),
        "clamp": bool(args.preprocs["clamp"]),
        # per-segment median/IQR precomputed at build; the in-step collate is
        # elementwise (ops.scaling.apply_scale_stats)
        "precomputed": True,
        "channels_last": bool(args.select("tpu.channels_last_io", False)),
    }


def resolve_channels_last(args) -> bool:
    """The CLI's rule for ``tpu.channels_last_io: null``: on with
    device-resident data (batches gather time-major and the encoder skips
    every layout transpose), off otherwise. Written back into ``args``
    before the collate and the encoder read it."""
    if args.select("tpu.device_resident_data", False) and args.select("tpu.channels_last_io", None) is None:
        args.set_path("tpu.channels_last_io", True)
    return bool(args.select("tpu.channels_last_io", False))


def resolve_seed(args) -> int:
    """``reproducible`` gates determinism as the reference's flag gates
    torch's deterministic algorithms [ref: train.py:33-43]: when it is off,
    each run draws a fresh seed from OS entropy. The seed is recorded as
    ``resolved_seed`` (in place on ``args``, hence in the run dir's config
    snapshot), so resume and ``tools/evaluate.py`` rebuild the run's split
    pools and its fixed test batch instead of drawing another split."""
    seed = args.select("resolved_seed", None)
    if seed is None:
        seed = int(args.get("seed", 0)) if args.get("reproducible", True) else int.from_bytes(os.urandom(4), "little")
    seed = int(seed)
    args.set_path("resolved_seed", seed)
    return seed


def run(args, device=None) -> List[Dict]:
    """Train per the config on ``device`` (under torchrun, the rank's card
    ``cuda:LOCAL_RANK``, or the CPU over gloo with ``device="cpu"``);
    returns the per-epoch metrics history."""
    # the multi-process bootstrap comes before the first use of the card
    # (a no-op for one process)
    multihost = maybe_init_distributed(args, device)
    group = current_group(device)
    is_primary = group is None or group.is_primary
    dev = group.device if group is not None else resolve_device(device)
    seed = resolve_seed(args)
    if group is not None:
        # every rank's initial parameters and global batch ids come from one
        # shared seed: rank 0's draw, so reproducible=False stays safe
        seed = broadcast_ints([seed], group)[0]
        args.set_path("resolved_seed", seed)
    seed_everything(seed)
    rng = np.random.default_rng(seed)
    cprint(f"Device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}", "cyan")
    cprint(args, "white")

    collate = None
    batchers = {}
    if args.dataset == "Gwilliams2022":
        train_set, test_set, train_pool, test_pool = build_gwilliams(args, rng, dev)
        num_subjects = train_set.num_subjects
        channels_last = resolve_channels_last(args)
        # batch-time baseline/scale/clamp (the reference collator)
        collate = build_collate(args)
        accumulate_steps = 1

        # device-resident data: recordings, embeddings and stats live on the
        # card; each step ships only indices (data/device_resident.py)
        if args.select("tpu.device_resident_data", False):
            from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams

            store = str(args.select("tpu.data_dtype", "float32"))
            for ds in {id(train_set): train_set, id(test_set): test_set}.values():
                batchers[id(ds)] = DeviceResidentGwilliams(ds, store_dtype=store, channels_last=channels_last,
                                                           device=dev)

        def make_batch(ds, batch_rng, ids, choices=None):
            b = batchers.get(id(ds))
            if b is not None:
                return b.gather(b.make_index_batch(batch_rng, ids, choices))
            return ds.sample_batch(batch_rng, ids, choices)

        def train_batches(epoch_rng):
            if args.use_sampler:
                ids_iter = iter_updates_batches(train_pool, args.batch_size, args.updates, epoch_rng)
            else:
                ids_iter = iter_shuffled_batches(train_pool, args.batch_size, epoch_rng, drop_last=multihost)
            for ids in ids_iter:
                if multihost:
                    # the global batch's ids and session choices, drawn alike
                    # on every rank; the rank materializes its block only
                    choices = train_set.draw_choices(epoch_rng, len(ids))
                    blk = host_local_slice(len(ids))
                    yield make_batch(train_set, epoch_rng, ids[blk], choices[blk])
                else:
                    yield make_batch(train_set, epoch_rng, ids)

    elif args.dataset == "Brennan2018":
        from speech_decoding_tpu_torch.data.brennan2018 import Brennan2018Dataset

        train_set = test_set = Brennan2018Dataset(args, device=dev)
        num_subjects = train_set.num_subjects
        train_pool, test_pool = random_split(len(train_set), args.split_ratio, rng)
        cprint(f"Number of samples: {len(train_pool)} (train), {len(test_pool)} (test)", "blue")
        # one optimizer step per epoch [ref: train.py:205-209], correctly
        # accumulated over a fixed number of batches
        accumulate_steps = max(1, len(train_pool) // args.batch_size)

        def make_batch(ds, batch_rng, ids):
            return ds.sample_batch(batch_rng, ids)

        def train_batches(epoch_rng):
            for ids in iter_shuffled_batches(train_pool, args.batch_size, epoch_rng,
                                             drop_last=accumulate_steps > 1 or multihost):
                if multihost:
                    # the global random-subject draw, the rank's block (as above)
                    choices = train_set.draw_choices(epoch_rng, len(ids))
                    blk = host_local_slice(len(ids))
                    yield train_set.sample_batch(epoch_rng, ids[blk], choices[blk])
                else:
                    yield train_set.sample_batch(epoch_rng, ids)

    else:
        raise ValueError("Unknown dataset")

    loc = ch_locations_2d(args.dataset, args.root_dir)
    # the JAX Trainer initializes from PRNGKey(seed): config seed, not the
    # resolved one
    encoder = BrainEncoder.from_config(args, loc, num_subjects,
                                       generator=torch.Generator().manual_seed(int(args.get("seed", 0))))
    logger = make_wandb_logger(args) if args.use_wandb and is_primary else NoopLogger()

    # per-run output isolation, like the reference's fresh Hydra chdir'd
    # output dir [ref: configs/config.yaml:51-54]: unless checkpoint.dir or
    # run_dir is given (resume = point at the previous run's dir), each run
    # gets {root_dir}/outputs/<date>/<time>_<name>/ with its resolved config
    # snapshot and checkpoints inside
    ckpt_dir = args.select("checkpoint.dir", None)
    run_dir = args.select("run_dir", None)
    if multihost:
        # checkpointing is symmetric (every rank has a manager on one shared
        # directory, or none has): only an explicit checkpoint.dir gives one.
        # Per-rank timestamped run dirs would differ, so only the primary
        # writes the run dir's config snapshot
        if ckpt_dir is None and is_primary:
            cprint("multi-process run without checkpoint.dir: checkpointing DISABLED "
                   "(set checkpoint.dir on a shared filesystem)", "yellow")
        if not is_primary:
            run_dir = None
    elif run_dir is None and ckpt_dir is None:
        name = "_".join(str(p) for p in (args.get("run_name", "run"), args.get("split_mode", "")) if p)
        run_dir = os.path.join(args.root_dir, "outputs", f"{datetime.now():%Y-%m-%d/%H-%M-%S}_{name}")
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(args.to_dict(), f, default_flow_style=False)
        cprint(f"Run dir: {run_dir}", "cyan")
        if ckpt_dir is None and not multihost:
            # absolute: run_dir already includes root_dir
            ckpt_dir = os.path.abspath(os.path.join(run_dir, "checkpoints"))
    ckpts = None
    if ckpt_dir is not None:
        if not os.path.isabs(ckpt_dir):
            ckpt_dir = os.path.join(args.root_dir, ckpt_dir)
        ckpts = CheckpointManager(
            ckpt_dir,
            keep=int(args.select("checkpoint.keep", 3)),
            every_epochs=int(args.select("checkpoint.every_epochs", 1)),
            # best-model tracking (checkpoint.track_metric="" disables)
            track_metric=args.select("checkpoint.track_metric", "testTop10acc") or None,
            track_mode=str(args.select("checkpoint.track_mode", "max")),
        )
    trainer = Trainer(encoder, args, accumulate_steps=accumulate_steps, collate=collate, logger=logger,
                      checkpoints=ckpts, device=dev)

    def test_batch(salt: int = 0):
        return make_batch(test_set, np.random.default_rng(seed + 1 + salt), test_pool)

    # default: one fixed test batch (deterministic eval across epochs).
    # tpu.redraw_test_batch=True re-draws the random session/subject per
    # epoch, as the reference samples per access in __getitem__
    # [ref: gwilliams2022.py:133, brennan2018.py:148]
    redraw = bool(args.select("tpu.redraw_test_batch", False))

    # cooperative SIGTERM handling: checkpoint mid-epoch and exit cleanly;
    # tpu.preempt_after_steps=N self-injects a SIGTERM after N dispatches
    # (the fault-injection drill). See training/preemption.py.
    guard = None
    if bool(args.select("tpu.preemption_guard", True)):
        inject = args.select("tpu.preempt_after_steps", None)
        guard = PreemptionGuard(inject_after_steps=int(inject) if inject else None).install()
        trainer.preemption = guard

    try:
        tb = test_batch()
        for epoch in range(trainer.start_epoch, args.epochs):
            epoch_rng = np.random.default_rng(seed * 100003 + epoch)
            # epoch > 0 (not start_epoch): a resumed run redraws the batches
            # an uninterrupted run would, so eval metrics stay comparable
            # across resume boundaries and evaluate can rebuild the batch
            if redraw and epoch > 0:
                tb = test_batch(salt=1000 * epoch)
            trainer.run_epoch(epoch, train_batches(epoch_rng), tb)
            if trainer.preempted:
                break
        if trainer.checkpoints:
            trainer.checkpoints.wait()
    finally:
        if guard is not None:
            guard.uninstall()
    return trainer.history


def parse_argv(argv: List[str]):
    """``[config.yaml] key=value ...`` -> the config, with ``root_dir``
    defaulting to the repository root."""
    config_path = None
    if argv and argv[0].endswith((".yaml", ".yml")):
        config_path, argv = argv[0], argv[1:]
    args = load_config(config_path, argv)
    if "root_dir" not in args:
        args.root_dir = ROOT_DIR
    return args


def main(argv=None) -> None:
    run(parse_argv(sys.argv[1:] if argv is None else list(argv)))


if __name__ == "__main__":
    main()
