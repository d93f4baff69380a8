"""The training cells: the port's ``Trainer.run_epoch`` fed as ``train.py``
feeds it, timed over a window.

Set-up builds one trainer from the seed's weights and the feed's world
(``port_bench/feeds/<traffic's feed>.py``) and drives it through its first
``tpu.scan_steps`` steps in one ``run_epoch`` call, so they go down the
window's own path: the Prefetcher stacks them into one scan group and
``train_step_scan`` runs them with the masks of steps 0, 1, ... Hooks on
the program's Adam keep the gradient it got at its first update (from its
first moment, m = (1 − β1)·g) and the parameters after the
``check_steps``-th; a wrapper around the step keeps each step's loss. The
hooks and the wrapper are gone before the window. The rows of those first
steps all differ. One more epoch of one scan group warms the window's path.
The window then runs one epoch on the same trainer until ``seconds`` have
passed, and every segment trained counts. After the window the trainer is
freed and the reference follows the first ``check_steps`` steps from the
same start.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from port_bench import cells, check, program_spans, reference, world
from port_bench.clock import log
from port_bench.trace import Trace, gc_pauses, maybe_profile, span


def _args(cfg: Dict, traffic: Dict, seed: int, extra: List[str]):
    from speech_decoding_tpu_torch.config import load_config

    over = [f"seed={seed}", f"dataset={cfg['dataset']}", f"batch_size={traffic['batch']}",
            f"lr={cfg['lr']}", f"init_temperature={cfg['init_temperature']}", f"reduction={cfg['reduction']}",
            f"d_drop={cfg['d_drop']}", f"D1={cfg['D1']}", f"D2={cfg['D2']}", f"K={cfg['K']}", f"F={cfg['F']}",
            f"preprocs.last4layers={str(cfg['F'] == 1024).lower()}",
            f"split_ratio={cfg['split_ratio']}", f"preprocs.clamp_lim={cfg['clamp_lim']}",
            f"tpu.compute_dtype={cfg['compute_dtype']}", f"tpu.conv_impl={cfg['conv_impl']}",
            f"tpu.fused_train_blocks={str(cfg['fused_train_blocks']).lower()}",
            f"tpu.scan_steps={cfg['scan_steps']}", "tpu.preemption_guard=false"]
    return load_config(None, over + extra)


def _encoder(cfg: Dict, args, params: Dict[str, torch.Tensor]):
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    enc = BrainEncoder.from_config(args, reference.layout(cfg["layout"]), cfg["S"],
                                   generator=torch.Generator().manual_seed(0))
    enc.load_state_dict(params, strict=True)
    return enc


def _leaves(trainer) -> Dict[str, torch.Tensor]:
    return {**dict(trainer.state.encoder.named_parameters()), "temp": trainer.state.clip.temp}


def _host_copy(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: p.detach().float().cpu().clone() for n, p in leaves.items()}


def _first_grad(trainer) -> Dict[str, torch.Tensor]:
    """The gradient Adam got at its one update so far, from its first
    moment (zeros where it has none)."""
    adam = trainer.state.optimizer
    out = {}
    for n, p in _leaves(trainer).items():
        m = adam.state.get(p, {}).get("exp_avg")
        out[n] = torch.zeros(p.shape) if m is None else m.detach().float().cpu() / (1 - check.ADAM_B1)
    return out


def memory_peak(device: torch.device) -> int:
    """The caching allocator's reserved peak since its last reset: every
    cached block and every CUDA graph's pool, what decides whether the job
    fits on the card. A graph's replay allocates nothing, so the allocated
    peak misses its pool."""
    return torch.cuda.max_memory_reserved(device)


class FirstSteps:
    """Watches the program's first steps: each step's loss (a wrapper
    around the trainer's single and scan steps), the gradient of the first
    Adam update and the parameters after the ``n``-th (hooks on the
    optimizer). ``close()`` restores the steps and removes the hooks."""

    def __init__(self, trainer, n: int):
        self.trainer, self.n = trainer, n
        self.losses: List[torch.Tensor] = []
        self.grad = self.after = None
        self.updates = 0
        self._saved = trainer.train_step, trainer.train_step_scan
        trainer.train_step = self._keep_loss(trainer.train_step)
        if trainer.train_step_scan is not None:
            trainer.train_step_scan = self._keep_loss(trainer.train_step_scan)
        self._hook = trainer.state.optimizer.register_step_post_hook(self._after_update)

    def _keep_loss(self, step):
        def stepped(*a, **k):
            state, metrics = step(*a, **k)
            self.losses.append(metrics["loss"].detach().float().reshape(-1))
            return state, metrics

        return stepped

    def _after_update(self, optimizer, args, kwargs) -> None:
        self.updates += 1
        if self.updates == 1:
            self.grad = _first_grad(self.trainer)
        if self.updates == self.n:
            self.after = _host_copy(_leaves(self.trainer))

    def close(self):
        """(losses of the first n steps, first gradient, parameters after
        the n-th update). Where the optimizer made fewer updates, the
        gradient is read from its state as it is and the parameters are
        those after the steps run."""
        self._hook.remove()
        self.trainer.train_step, self.trainer.train_step_scan = self._saved
        losses = torch.cat(self.losses).tolist()[: self.n] if self.losses else []
        grad = self.grad if self.grad is not None else _first_grad(self.trainer)
        after = self.after if self.after is not None else _host_copy(_leaves(self.trainer))
        return losses, grad, after


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        faults=(), root: str = cells.ROOT) -> Dict:
    from speech_decoding_tpu_torch.training.trainer import Trainer

    cuda = device.type == "cuda"
    feeds = cells.load("feeds", traffic["feed"], root)
    if feeds.DATASET != cfg["dataset"]:
        raise ValueError(f"feed {traffic['feed']} does not serve {cfg['dataset']}")
    B = int(traffic["batch"])
    feed = feeds.Feed(cfg, traffic, seed, device)
    args = _args(cfg, traffic, seed, feed.config_overrides(cfg))
    log("world drawn")
    params = world.make_params(cfg, seed, device)
    p0 = _host_copy(params)
    p0["temp"] = torch.tensor([float(cfg["init_temperature"])])
    trainer = Trainer(_encoder(cfg, args, params), args, collate=feed.collate(args), device=device)
    for f in faults:
        f(trainer)
    del params
    log("trainer built")

    # the first steps: whole scan groups in one epoch call, rows all distinct
    n_check, k = int(traffic["check_steps"]), max(1, int(cfg["scan_steps"]))
    watch = FirstSteps(trainer, n_check)
    trainer.run_epoch(0, feed.epoch(0, n_batches=k * math.ceil(n_check / k), distinct=True, record=True), None)
    prog_losses, prog_grad, prog_after = watch.close()
    del watch
    log("check steps done")
    # warm the window's path: one more scan group
    for e in range(int(traffic["warm_epochs"])):
        trainer.run_epoch(1 + e, feed.epoch(1 + e, n_batches=k), None)
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = memory_peak(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log("set-up done")

    # the window: one epoch until the deadline
    steps = [0]
    losses = []
    with maybe_profile(trace, device.type) as prof, gc_pauses(trace) as pauses, span("window"):
        t0 = time.perf_counter()
        if seconds > 0:
            with span("run_epoch"):
                out = trainer.run_epoch(10_000, feed.epoch(10_000, deadline=t0 + seconds, counter=steps), None)
            losses.append(out["train_loss"])
        if cuda:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    window_s = max(t1 - t0, 1e-9)
    log("window done")
    window_peak = memory_peak(device) if cuda else 0
    tr = Trace(prof, step=program_spans.STEP, pauses=pauses) if prof is not None else None
    segments = steps[0] * B
    failed = 0 if all(math.isfinite(x) for x in losses) else steps[0]

    # free the program, then the reference follows the first steps
    del trainer
    ref_batches = feed.reference_batches(n_check)
    feed.close()
    del feed
    if cuda:
        torch.cuda.empty_cache()
    ref = _reference(cfg, seed, p0, ref_batches, device, "f32")
    gaps = check.train_gaps(prog_losses, ref[0], prog_grad, ref[1], p0, prog_after, ref[2])
    readings = check.summarize(gaps)

    def control() -> Dict[str, float]:
        """The reference in the control's precision in the program's place."""
        c = _reference(cfg, seed, p0, ref_batches, device, "control")
        return check.train_readings(c[0], ref[0], c[1], ref[1], p0, c[2], ref[2])

    return {
        "e2e": {"train_segments_per_s": segments / window_s, "setup_s": setup_s,
                "peak_mem_gib": window_peak / 2**30},
        "counts": {"steps": steps[0], "segments": segments, "batch": B},
        "window_s": window_s, "trace": tr, "readings": readings, "control": control, "worst": check.worst(gaps),
        "attempted": steps[0], "failed": failed,
        "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0,
    }


def _reference(cfg: Dict, seed: int, p0: Dict, batches: List[Dict], device, precision: str):
    """The reference's first steps from ``p0`` on ``batches``: (losses,
    first update's gradient, leaves after)."""
    loc = reference.layout(cfg["layout"])
    bases = tuple(b.to(device) for b in reference.fourier_bases(loc, cfg["K"]))
    masks = [reference.drop_mask(seed, i, loc, cfg["d_drop"]) for i in range(len(batches))]
    params0 = {n: t for n, t in p0.items() if n != "temp"}
    return reference.train_steps(params0, float(p0["temp"][0]), batches, masks, bases, float(cfg["lr"]),
                                 reference.Prec(precision), device)
