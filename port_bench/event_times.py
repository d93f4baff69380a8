"""CUDA-event times at a training cell's own size, read without the
profiler: the device time of one train step run back to back, and of K2's
fifteen launches of a step. The traced window's device readings are held
to them (``PERF.md``).

    python3 -m port_bench.event_times --workload gw208-train-b256-resident --seed <n> [--reps 30]

Builds the trainer as the cell's set-up does (weights and world from the
seed), runs two scan groups so the step's graph is captured, then times
``reps`` scan groups of one stacked batch back to back between two CUDA
events. K2 (``tap_conv_dw``) runs on random bf16 inputs at the cell's batch,
each conv's shape and dilation, its channel padding made outside the
timing (the trace counts K2's kernels alone): eager, back to back, and
replayed as one CUDA graph of the fifteen launches. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import cells, flops, world


def _elapsed_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def step_ms(cfg, traffic, seed: int, reps: int, device, root: str = cells.ROOT) -> float:
    """Device ms a train step: ``reps`` scan groups of one stacked batch,
    back to back, after two groups that capture and replay the graph."""
    import torch

    from speech_decoding_tpu_torch.training.trainer import Trainer

    train = cells.load("drivers", traffic["driver"], root)
    feed = cells.load("feeds", traffic["feed"], root).Feed(cfg, traffic, seed, device)
    args = train._args(cfg, traffic, seed, feed.config_overrides(cfg))
    trainer = Trainer(train._encoder(cfg, args, world.make_params(cfg, seed, device)), args,
                      collate=feed.collate(args), device=device)
    k = int(cfg["scan_steps"])
    group = list(feed.epoch(0, n_batches=k))
    batch = trainer._put({n: torch.stack([b[n] for b in group]) for n in group[0]})
    masks = torch.stack([trainer._step_mask(i) for i in range(k)])

    def one_group():
        trainer.state, _ = trainer.train_step_scan(trainer.state, batch, drop_masks=masks)

    for _ in range(2):
        one_group()
    return _elapsed_ms(one_group, reps) / (reps * k)


def k2_ms(cfg, batch: int, reps: int, device) -> dict:
    """Device ms of K2's fifteen launches of a step, eager and as a graph."""
    import torch

    from speech_decoding_tpu_torch.ops.conv_block import dilations
    from speech_decoding_tpu_torch.ops.tap_conv import pad_channels, tap_conv_dw

    g = torch.Generator(device=device).manual_seed(0)
    T = cfg["T"]
    ds = [d for k in range(5) for d in (*dilations(k), 2)]
    args = []
    for (cin, cout), d in zip(flops.conv3_shapes(cfg), ds):
        x = torch.randn(batch, T, cin, generator=g, device=device).to(torch.bfloat16)
        gy = torch.randn(batch, T, cout, generator=g, device=device).to(torch.bfloat16)
        args.append((x, gy, d, pad_channels(x)))

    def fifteen():
        for x, gy, d, xp in args:
            tap_conv_dw(x, gy, d, padded=xp)

    for _ in range(3):
        fifteen()
    eager = _elapsed_ms(fifteen, reps) / reps
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fifteen()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fifteen()
    graph.replay()
    replayed = _elapsed_ms(graph.replay, reps) / reps
    bound = 1e3 * flops.k2_bound_s_per_step(cfg, batch)
    return {"k2_eager_ms": eager, "k2_graph_ms": replayed, "k2_bound_ms": bound,
            "k2_eager_share": 100 * bound / eager, "k2_graph_share": 100 * bound / replayed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.event_times: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.Cell(a.workload)
    dev = torch.device("cuda")
    t = time.perf_counter()
    out = {"workload": a.workload, "seed": a.seed, "kind": torch.cuda.get_device_name(dev),
           **k2_ms(cell.config, int(cell.traffic["batch"]), a.reps, dev)}
    torch.cuda.empty_cache()
    out["step_ms"] = step_ms(cell.config, cell.traffic, a.seed, a.reps, dev)
    out["seconds"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
