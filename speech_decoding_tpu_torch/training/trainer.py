"""Training orchestration: the reference's epoch loop.

Port of ``speech_decoding_tpu/training/trainer.py``, with its semantics
[ref: train.py:166-259]:
  * per epoch: train batches -> loss/top1/top10 accumulation -> full
    test-set eval -> stdout metrics line -> optional W&B -> checkpoint;
  * Gwilliams: per-batch Adam steps over ``updates`` sampled batches;
  * Brennan: one optimizer step per epoch. The reference only backprops the
    *last* batch [ref: train.py:205-209]; ``tpu.brennan_legacy_accumulation``
    replicates that quirk, the default accumulates all batch gradients
    through ``MultiSteps``.

Where the port differs from the JAX Trainer:
  * **Fused blocks.** JAX ignores ``tpu.fused_train_blocks`` off a TPU. The
    port runs K6 on the card and its plain stages on the CPU, as
    ``make_train_step(fused_blocks=True)`` does.
  * **Data parallelism.** Where ``torch.distributed`` is initialized the
    Trainer is one rank of the "data" group (``parallel.DataGroup``; its
    device ``cuda:LOCAL_RANK`` unless the caller names one): its steps are
    data-parallel steps on the global batch (``training/steps.py``), each
    rank's train batches are its own blocks (``host_local_slice`` rows of
    each global batch, as JAX's multi-host Trainer takes them; a scan group
    stacks blocks, (k, b, ...)), the test batch is the whole one on every
    rank (each rank evaluates it, as JAX's multi-process eval does), every
    rank or none has a checkpoint manager, and the primary alone prints and
    logs. ``multihost`` is true above one rank; at a world size of 1 the
    same code path runs with trivial collectives.
  * **Dropout.** Each step's spatial-dropout centre is drawn from a CPU
    generator seeded from (``seed``, ``state.step``), as JAX folds
    ``state.step`` into a constant key, so a resumed run draws the masks an
    uninterrupted run would draw at the same step. The two frameworks' draws
    differ (threefry against Philox).
  * **No sync per step.** Metrics stay 0-dim tensors on the device during
    the epoch and are copied to the host once, at its end, as JAX pulls
    them once.

Preemption keeps the JAX cadence logic (``_preempt_check``): under a group
the ranks agree by an all-reduce (MAX) at a fixed dispatch cadence, so every
rank enters the checkpoint save at the same step.

Batches: dicts of X, Y, subject_idxs (and scale_stats for the precomputed
collate), as numpy arrays or tensors. Host arrays go to the card from
pinned memory with ``non_blocking=True``, on the stream the steps run on,
so a step never reads a half-copied batch; each batch gets a fresh pinned
block, which PyTorch's caching host allocator does not hand out again
before its copy has finished. Tensors already on the state's device (a
device-resident pool, as in ``tools/scale_run.py``) pass through untouched.
``subject_idxs`` stay on the host, where the per-subject kernel checks them.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from speech_decoding_tpu_torch.data.native_loader import Prefetcher
from speech_decoding_tpu_torch.models.brain_encoder import spatial_dropout_mask
from speech_decoding_tpu_torch.parallel.collectives import all_reduce_int, assert_same_on_ranks
from speech_decoding_tpu_torch.parallel.mesh import current_group, put_batch
from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
from speech_decoding_tpu_torch.training.state import create_train_state
from speech_decoding_tpu_torch.training.steps import (
    make_chunked_eval,
    make_eval_step,
    make_train_forward_step,
    make_train_step,
    make_train_step_scan,
)
from speech_decoding_tpu_torch.utils.logging import cprint


class NoopLogger:
    def log(self, metrics: Dict) -> None:
        pass


def make_wandb_logger(args):
    """W&B metric logging, gated on availability [ref: train.py:134-143]."""
    try:
        import wandb
    except ImportError:
        cprint("wandb not installed; metrics go to stdout only", "yellow")
        return NoopLogger()
    config = {k: v for k, v in args.to_dict().items() if k not in ("root_dir", "wandb")}
    wandb.init(project=args.wandb.project, entity=args.wandb.entity, config=config, save_code=True)
    wandb.run.name = f"{args.wandb.run_name}_{args.split_mode}"
    wandb.run.save()
    return wandb


class Trainer:
    """Drives train/eval epochs for either dataset family.

    ``train_batches`` of ``run_epoch`` yields batch dicts; ``test_batch`` is
    the single full-test-set batch [ref: train.py:95-99]. ``encoder`` is
    used as given: the caller seeds its initialization. ``sample_batch`` is
    the JAX signature's initialization batch and is not read. The state
    lives on ``device`` (default ``cuda``, or ``cuda:LOCAL_RANK`` under a
    process group; raises without a GPU unless ``device="cpu"``). Under a
    process group every rank builds ``encoder`` from the same seed (checked)
    and passes its own blocks of the train batches."""

    def __init__(self, encoder, args, sample_batch: Optional[Dict] = None, accumulate_steps: int = 1,
                 collate: Optional[Dict] = None, logger=None, checkpoints: Optional[CheckpointManager] = None,
                 device=None):
        self.args = args
        self.encoder = encoder
        self.group = group = current_group(device)
        self.multihost = group is not None and group.world > 1
        self.is_primary = group is None or group.is_primary
        self.logger = logger or NoopLogger()
        self.checkpoints = checkpoints
        if group is not None and all_reduce_int(checkpoints is not None, group) not in (0, group.world):
            raise RuntimeError("checkpointing must be symmetric: every rank has a CheckpointManager on one "
                               "shared directory, or none has")
        self.legacy_last_batch_only = bool(args.select("tpu.brennan_legacy_accumulation", False))
        self.seed = int(args.get("seed", 0))
        self.state = create_train_state(encoder, init_temperature=float(args.init_temperature), lr=float(args.lr),
                                        accumulate_steps=accumulate_steps, device=device, group=group)
        self.device = self.state.device
        fused = bool(args.select("tpu.fused_train_blocks", False))
        self.train_step = make_train_step(args.reduction, collate, fused_blocks=fused, group=group)
        self.scan_steps = int(args.select("tpu.scan_steps", 1))
        self.train_step_scan = (make_train_step_scan(args.reduction, collate, fused_blocks=fused, group=group)
                                if self.scan_steps > 1 else None)
        self.eval_step = make_eval_step(args.reduction, collate)
        # large test sets evaluate in fixed-size forward chunks (bounded
        # activation memory); 0 disables
        self.eval_chunk_size = int(args.select("tpu.eval_chunk_size", 1024))
        self._chunked_eval = None
        self._collate = collate
        self.forward_step = (make_train_forward_step(args.reduction, collate, group=group)
                             if self.legacy_last_batch_only else None)
        self.start_epoch = 0
        if self.checkpoints and args.select("checkpoint.resume", True):
            if group is not None:
                assert_same_on_ranks(str(self.checkpoints.latest_epoch()).encode(), group,
                                     "the latest checkpoint epoch (is the checkpoint directory shared?)")
            if self.checkpoints.latest_epoch() is not None:
                self.state, epoch = self.checkpoints.restore(self.state)
                self.start_epoch = epoch + 1
        self.history: List[Dict] = []
        # host-clock seconds of the last epoch's train loop, eval and checkpoint
        self.last_epoch_seconds: Dict[str, float] = {}
        # cooperative preemption (training/preemption.py): the caller installs
        # a PreemptionGuard and assigns it here; run_epoch polls it between
        # dispatches and checkpoints mid-epoch on request
        self.preemption = None
        self.preempted = False
        self._preempt_sync_every = max(1, int(args.select("tpu.preempt_sync_every", 25)))
        self._dispatch_seq = 0  # monotonic across epochs (multi-host cadence)
        self._forward_draws = 0  # legacy forward-only steps do not advance state.step

    # -- dropout ---------------------------------------------------------------

    def _drop_mask(self, *key: int) -> torch.Tensor:
        """The (C,) spatial-dropout mask of ``key``, on the host."""
        seed = int(np.random.SeedSequence([self.seed, *key]).generate_state(1)[0])
        return spatial_dropout_mask(torch.Generator().manual_seed(seed), self.encoder.loc, self.encoder.d_drop)

    def _step_mask(self, step: int) -> torch.Tensor:
        return self._drop_mask(0, step)

    # -- preemption -------------------------------------------------------------

    def _preempt_check(self, sync: bool = False) -> bool:
        """Poll the guard after a dispatch. One process: act on the local
        flag at once. Several: processes agree at a fixed dispatch cadence
        so every process enters the checkpoint save at the same step. The
        cadence counter is monotonic ACROSS epochs — a per-epoch index would
        never reach the cadence when an epoch has fewer dispatches than
        ``tpu.preempt_sync_every`` — and ``sync=True`` (called once at every
        epoch end) forces an agreement point, so a flag is acted on within
        one epoch at worst."""
        if self.preemption is None or self.preempted:
            return self.preempted
        if not sync:
            self.preemption.step_tick()
            self._dispatch_seq += 1
        flag = self.preemption.requested
        if self.multihost:
            if not sync and self._dispatch_seq % self._preempt_sync_every:
                return False
            if self.group is not None:
                flag = bool(all_reduce_int(flag, self.group, torch.distributed.ReduceOp.MAX))
        if flag:
            self.preempted = True
        return flag

    # -- batches ------------------------------------------------------------------

    def _put(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch (under a group, the rank's block) on the state's device."""
        return put_batch(batch, self.device)

    def _grouped(self, it):
        """Groups of ``scan_steps`` batches stacked on a leading axis (host
        arrays with numpy, device tensors with torch), then the remainder
        one by one: (batch, k) with k = 0 for a single batch."""
        group = []
        for b in it:
            group.append(b)
            if len(group) == self.scan_steps:
                stack = torch.stack if torch.is_tensor(group[0]["X"]) else np.stack
                yield {k: stack([g[k] for g in group]) for k in group[0]}, len(group)
                group = []
        for b in group:
            yield b, 0

    # -- the epoch -----------------------------------------------------------------

    def run_epoch(self, epoch: int, train_batches: Iterable[Dict], test_batch: Optional[Dict]) -> Dict[str, float]:
        t0 = time.perf_counter()
        train_metrics: List[Dict[str, torch.Tensor]] = []
        segments = 0
        if self.legacy_last_batch_only:
            # reference quirk: only the LAST batch's grads step the optimizer
            # [ref: train.py:205-209]
            train_batches = list(train_batches)
            last_idx = len(train_batches) - 1
            for i, batch in enumerate(train_batches):
                segments += batch["X"].shape[0]
                if i == last_idx:
                    self.state, metrics = self.train_step(self.state, self._put(batch),
                                                          drop_mask=self._step_mask(self.state.step))
                else:
                    self._forward_draws += 1
                    self.state, metrics = self.forward_step(self.state, self._put(batch),
                                                            drop_mask=self._drop_mask(1, self._forward_draws))
                train_metrics.append(metrics)
                if self._preempt_check():
                    break
        elif self.scan_steps > 1:
            # scan mode: k optimizer steps per dispatch (a host thread stacks
            # and transfers groups while the device runs the previous group)
            pf = Prefetcher(self._grouped(iter(train_batches)), transform=lambda t: (self._put(t[0]), t[1]))
            for batch, k_group in pf:
                step = self.state.step
                if k_group:
                    segments += batch["X"].shape[0] * batch["X"].shape[1]
                    masks = torch.stack([self._step_mask(step + i) for i in range(k_group)])
                    self.state, metrics = self.train_step_scan(self.state, batch, drop_masks=masks)
                else:
                    segments += batch["X"].shape[0]
                    self.state, metrics = self.train_step(self.state, batch, drop_mask=self._step_mask(step))
                train_metrics.append(metrics)
                if self._preempt_check():
                    break
        else:
            # background host thread: batch assembly and transfer overlap
            # with device compute
            for batch in Prefetcher(iter(train_batches), transform=self._put):
                segments += batch["X"].shape[0]
                self.state, metrics = self.train_step(self.state, batch, drop_mask=self._step_mask(self.state.step))
                train_metrics.append(metrics)
                if self._preempt_check():
                    break
        # epoch-end agreement point: a pending preemption is acted on even
        # when the epoch is shorter than the multi-process sync cadence
        self._preempt_check(sync=True)
        # one copy to the host for the epoch; scan-mode entries carry a
        # leading k axis — flatten them
        keys = list(train_metrics[0])
        rows = torch.stack([torch.cat([m[k].float().reshape(-1) for m in train_metrics]) for k in keys]).cpu()
        pulled = [{k: float(v) for k, v in zip(keys, col)} for col in rows.T.tolist()]
        train_time = time.perf_counter() - t0
        if self.group is not None:
            segments *= self.group.world  # local rows -> global rows

        out: Dict[str, float] = {
            "epoch": epoch,
            "train_loss": float(np.mean([m["loss"] for m in pulled])),
            "trainTop1acc": float(np.mean([m["top1"] for m in pulled])),
            "trainTop10acc": float(np.mean([m["top10"] for m in pulled])),
            "temp": pulled[-1]["temp"],
            "lrate": float(self.args.lr),
            "train_segments_per_sec": segments / max(train_time, 1e-9),
        }

        t_eval = time.perf_counter()
        if test_batch is not None and not self.preempted:
            # move the (large, constant) test batch once, not per epoch
            if getattr(self, "_test_cache_id", None) != id(test_batch):
                self._test_cache = self._put(test_batch)
                self._test_cache_id = id(test_batch)
            if 0 < self.eval_chunk_size < test_batch["X"].shape[0]:
                if self._chunked_eval is None:
                    self._chunked_eval = make_chunked_eval(self.args.reduction, self._collate,
                                                           chunk_size=self.eval_chunk_size)
                eval_fn = self._chunked_eval
            else:
                eval_fn = self.eval_step
            ev = eval_fn(self.state, self._test_cache)
            ev = dict(zip(ev, torch.stack([v.float() for v in ev.values()]).cpu().tolist()))
            out.update(test_loss=ev["loss"], testTop1acc=ev["top1"], testTop10acc=ev["top10"])
        t_save = time.perf_counter()

        if self.is_primary:
            cprint(
                f"Ep {epoch}/{self.args.epochs} | "
                f"train l: {out['train_loss']:.3f} | "
                f"test l: {out.get('test_loss', float('nan')):.3f} | "
                f"trainTop10acc: {out['trainTop10acc']:.3f} | "
                f"testTop10acc: {out.get('testTop10acc', float('nan')):.3f} | "
                f"temp: {out['temp']:.3f} | "
                f"{out['train_segments_per_sec']:.1f} seg/s",
                "white",
            )
            self.logger.log(out)
        self.history.append(out)
        if self.checkpoints:
            # a preempted epoch force-saves mid-epoch state regardless of the
            # every_epochs cadence — this is the whole point of the guard;
            # under a group every rank enters, the primary writes
            self.checkpoints.save(epoch, self.state, extra=out, force=self.preempted, group=self.group)
        self.last_epoch_seconds = {"train": train_time, "eval": t_save - t_eval,
                                   "checkpoint": time.perf_counter() - t_save}
        if self.preempted and self.is_primary:
            cprint(
                f"Preemption requested — epoch {epoch} stopped after "
                f"{len(train_metrics)} dispatch(es); state "
                f"{'checkpointed' if self.checkpoints else 'NOT saved (no checkpoint manager)'}; "
                f"resume continues at epoch {epoch + 1}",
                "yellow",
            )
        return out
