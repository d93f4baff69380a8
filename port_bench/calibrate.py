"""Readings for a cell's limits, on the card at the cell's own size: the
program's numbers over many seeds, the control's (the reference in the
precision below the configuration's, in the program's place) and the
half-batch and unchanged-state faults', each seed in the same process.

    python3 -m port_bench.calibrate --workload <name> --seeds 11,12,... \
        [--control 3] [--faults 3] [--out <file.jsonl>]

Prints one JSON line a reading: {"seed", "kind": program|control|half_batch|
state_unchanged, "readings": {...}}. The numbers compared come from set-up,
so no window is run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from port_bench import faults
from port_bench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="how many of the seeds also read the control")
    ap.add_argument("--faults", type=int, default=3,
                    help="how many of the seeds also read the faults (half batch, state unchanged)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    out = open(a.out, "a") if a.out else None
    seeds = [int(s) for s in a.seeds.split(",")]

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(seeds):
        _, o = run_cell(a.workload, seed, 0.0, False, a.device, limits_override={}, t_start=time.perf_counter())
        emit({"workload": a.workload, "seed": seed, "kind": "program", "readings": o["readings"],
              "worst": o["worst"], "e2e": o["e2e"]})
        if i < a.control:
            emit({"workload": a.workload, "seed": seed, "kind": "control", "readings": o["control"]()})
        del o
        gc.collect()
        if a.device == "cuda":
            torch.cuda.empty_cache()
        for fault in (faults.half_batch, faults.state_unchanged):
            if i >= a.faults:
                break
            _, o = run_cell(a.workload, seed, 0.0, False, a.device, limits_override={}, faults=[fault],
                            t_start=time.perf_counter())
            emit({"workload": a.workload, "seed": seed, "kind": fault.__name__, "readings": o["readings"]})
            del o
            gc.collect()
            if a.device == "cuda":
                torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
