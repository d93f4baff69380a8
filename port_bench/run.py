"""The port's benchmark: one cell, one run.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the workload named in ``BENCHMARK.json`` on the card this process
sees: set-up (weights and world from the seed, the program's first steps
and warm-up), a measured window of ``--seconds``, then the
comparison with the plain reference. With ``--trace 0`` the result line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics read from a ``torch.profiler`` trace of the window. The last line
of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exits 2 without a CUDA device (or with fewer than the cell asks for) and 3
if JAX or the JAX package was loaded; it prints no result then.
"""

from __future__ import annotations

from port_bench import clock  # first: the run's clock starts here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches inside the checkout at fixed paths; no library loads JAX by itself
for _k, _v in {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
               "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}.items():
    os.environ[_k] = os.path.join(_ROOT, _v)
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "speech_decoding_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name only begins like it)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", root: str = None,
             config_override=None, traffic_override=None, limits_override=None, faults=(), t_start: float = None):
    """One run of cell ``name``: (result dict, the driver's output). The
    driver is ``port_bench/drivers/<traffic's driver>.py``; its ``run``
    returns the window's end-to-end metrics, counts and trace, and the
    readings compared. The overrides and ``faults`` (callables given the
    program's trainer once set-up has built it) are for the benchmark's own
    tests."""
    import torch

    from port_bench import cells, check

    cell = cells.Cell(name, root or cells.ROOT)
    cfg = {**cell.config, **(config_override or {})}
    traffic = {**cell.traffic, **(traffic_override or {})}
    limits = limits_override if limits_override is not None else cell.limits
    dev = torch.device(device)
    driver = cells.load("drivers", traffic["driver"], cell.root)
    out = driver.run(cfg, traffic, seed, seconds, trace, dev, clock.T0 if t_start is None else t_start, faults,
                     cell.root)
    ok, checks = check.judge(out["readings"], limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        ctx = Context(cfg, traffic, out)
        metrics = {}
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    if dev.type == "cuda":
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                    "memory_peak_bytes": int(out["memory_peak_bytes"])}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(ok and out["failed"] == 0), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev_info}
    if trace and out["trace"] is not None:
        tr = out["trace"]
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        if tr.whole:
            result["breakdown"] = {"device_ops": tr.top_device_ops(10), "idle_gaps": tr.idle_gaps(10)}
        # where the trace lost device records, its device-side readings are left out
        result["trace_lost"] = tr.lost
    result["checks"] = checks
    return result, out


class Context:
    """What a per-layer metric's reader sees: the configuration, the
    traffic, the window's counts and length, and the trace."""

    def __init__(self, cfg, traffic, out):
        self.cfg, self.traffic = cfg, traffic
        self.counts = out["counts"]
        self.window_s = out["window_s"]
        self.trace = out["trace"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from port_bench import cells

    clock.log("torch imported")
    chips = cells.Cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    clock.log("card found")
    result, _ = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    clock.log("compared")
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=_num), flush=True)
    return 0


def _num(x):
    try:
        v = float(x)
    except (TypeError, ValueError):
        return str(x)
    return v if math.isfinite(v) else str(v)


if __name__ == "__main__":
    sys.exit(main())
