"""Device time of a training cell's step by kernel, at the cell's own size:
the step replayed as the cell's trainer replays it, a few scan groups under
``torch.profiler``, each kernel's records and ms a step by its full name,
and the same summed by kind (``KINDS``). ``PERF.md`` §5's table by kind is
read from it; a step's device time by CUDA events beside it holds the trace
to the clock.

    python3 -m port_bench.step_kernels --workload gw208-train-b256-resident --seed <n> [--out <file.json>]

Builds the trainer as ``event_times`` does (weights and world from the
seed), captures the step's graph, times ``reps`` scan groups of one stacked
batch between two CUDA events, then traces ``groups`` more. Prints one JSON
line (the totals and the kinds); ``--out`` also writes every kernel.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from typing import Dict, Tuple

from port_bench import cells, world

# (kind, pattern searched in a kernel's full name): the first that matches names the kind
KINDS = [("GLU kernels", r"glu_(fwd|bwd)_kernel"), ("BN + GELU kernels", r"bngelu_"),
         ("K1 and K2", r"subject_matmul|tap_conv_dw|reduce_splits"),
         ("cuBLAS GEMMs", r"nvjet|gemm|cutlass|xmma|sm90_|sm80_"),
         ("reductions", r"reduce_kernel"), ("cat", r"CatArray"), ("sigmoid", r"sigmoid"),
         ("multiplies", r"Mul"), ("copies", r"copy|Copy"), ("adds", r"Add"), ("GELU", r"[Gg]elu"),
         ("fills and memsets", r"fill|Memset|memset"), ("other elementwise", r".")]


def kind_of(name: str) -> str:
    """The kind of the kernel with this full name (``KINDS``' first match)."""
    return next(kind for kind, pat in KINDS if re.search(pat, name))


def by_kind(step: Dict[str, Tuple[float, float]]) -> Dict[str, Dict[str, float]]:
    """{kernel name: (records, ms) a step} summed by kind, largest ms first."""
    kinds = collections.defaultdict(lambda: [0.0, 0.0])
    for name, (records, ms) in step.items():
        k = kinds[kind_of(name)]
        k[0] += records
        k[1] += ms
    return {k: {"records": v[0], "ms": v[1]} for k, v in sorted(kinds.items(), key=lambda kv: -kv[1][1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=20, help="scan groups timed by CUDA events")
    ap.add_argument("--groups", type=int, default=3, help="scan groups traced")
    ap.add_argument("--out", default=None, help="a JSON file for every kernel's records and ms a step")
    a = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_bench.step_kernels: no CUDA device", file=sys.stderr)
        return 2
    from speech_decoding_tpu_torch.training.trainer import Trainer

    cell = cells.Cell(a.workload)
    cfg, traffic, dev = cell.config, cell.traffic, torch.device("cuda")
    train = cells.load("drivers", traffic["driver"], cells.ROOT)
    feed = cells.load("feeds", traffic["feed"], cells.ROOT).Feed(cfg, traffic, a.seed, dev)
    args = train._args(cfg, traffic, a.seed, feed.config_overrides(cfg))
    trainer = Trainer(train._encoder(cfg, args, world.make_params(cfg, a.seed, dev)), args,
                      collate=feed.collate(args), device=dev)
    k = int(cfg["scan_steps"])
    group = list(feed.epoch(0, n_batches=k))
    batch = trainer._put({n: torch.stack([b[n] for b in group]) for n in group[0]})
    masks = torch.stack([trainer._step_mask(i) for i in range(k)])

    def one_group():
        trainer.state, _ = trainer.train_step_scan(trainer.state, batch, drop_masks=masks)

    for _ in range(3):
        one_group()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(a.reps):
        one_group()
    end.record()
    torch.cuda.synchronize()
    out = {"workload": a.workload, "seed": a.seed, "kind": torch.cuda.get_device_name(dev),
           "step_ms_events": start.elapsed_time(end) / (a.reps * k)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(a.groups):
            one_group()
        torch.cuda.synchronize()
    steps = a.groups * k
    totals = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            totals[e.name][0] += 1
            totals[e.name][1] += e.time_range.elapsed_us() / 1e3
    step = {name: (n / steps, ms / steps) for name, (n, ms) in totals.items()}
    out["step_records"] = sum(n for n, _ in step.values())
    out["step_device_ms"] = sum(ms for _, ms in step.values())
    out["by_kind"] = by_kind(step)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({**out, "by_kernel": sorted(([n, c, ms] for n, (c, ms) in step.items()),
                                                  key=lambda r: -r[2])}, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
