"""CPU tests of the benchmark harness: discovery by name, the yardstick's
counts, the plain reference against the port, the path the compared steps
take, the batcher built as its constructor builds it, and the import rule.
Run with ``python -m pytest port_bench -q``."""

from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from port_bench import cells, flops, world  # noqa: E402
from port_bench.run import forbidden_modules, run_cell  # noqa: E402

ROOT = cells.ROOT
CELL = "gw208-train-b256-resident"
TINY_CFG = {"S": 3, "T": 48, "D1": 16, "D2": 16, "F": 32, "K": 4, "sessions": 1, "task_seconds": [20, 30, 25, 40]}
TINY_TRAFFIC = {"batch": 16}


def tiny_run(name=CELL, seconds=1.0, trace=False, f32=True, root=ROOT, **kw):
    cfg = {**TINY_CFG, "compute_dtype": "float32" if f32 else "bfloat16"}
    torch.manual_seed(0)
    return run_cell(name, 2**33 + 5, seconds, trace, "cpu", root=root, config_override=cfg,
                    traffic_override=TINY_TRAFFIC, t_start=time.perf_counter(), **kw)


def test_every_cell_finds_its_files():
    m = cells.manifest()
    assert [w["name"] for w in m["workloads"]] == [CELL]
    for w in m["workloads"]:
        c = cells.Cell(w["name"])
        assert c.config["name"] == w["config"]
        assert callable(cells.load("drivers", c.traffic["driver"]).run)
        assert cells.load("feeds", c.traffic["feed"]).DATASET == c.config["dataset"]
        assert c.limits, f"{w['name']} has no limits file"
        assert {e["name"] for e in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
        assert c.per_layer, f"{w['name']} reports no per-layer metric"
        for p in c.per_layer:
            assert callable(cells.metric_reader(p["name"]))
    for c in m["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


_WRAPPED_DRIVER = '''from port_bench import cells


def run(cfg, traffic, seed, seconds, trace, device, t_start, faults=(), root=cells.ROOT):
    out = cells.load("drivers", "train", root).run(cfg, traffic, seed, seconds, trace, device, t_start, faults, root)
    out["counts"]["driver"] = "counted"
    return out
'''

_COUNTING_FEED = '''from port_bench import cells

_base = cells.load("feeds", "device_resident")
DATASET = _base.DATASET


class Feed(_base.Feed):
    def epoch(self, *a, **k):
        for b in super().epoch(*a, **k):
            with open(__file__ + ".count", "a") as f:
                f.write("1")
            yield b
'''


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    """A configuration, a traffic mix with a driver and a feed of its own,
    a limits file and a per-layer metric, each a new file, with new
    manifest entries: the harness runs the new cell through the new driver
    and feed and reports the new metric, with no harness file edited."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "port_bench"
    cfg = json.loads((pb / "configs" / "gwilliams2022-meg208.json").read_text())
    cfg.update(TINY_CFG, name="gwilliams2022-tiny", compute_dtype="float32")
    (pb / "configs" / "gwilliams2022-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "resident_b256.json").read_text())
    traffic.update(batch=8, driver="train_counted", feed="device_resident_counted")
    (pb / "traffic" / "resident_b8.json").write_text(json.dumps(traffic))
    (pb / "drivers" / "train_counted.py").write_text(_WRAPPED_DRIVER)
    (pb / "feeds" / "device_resident_counted.py").write_text(_COUNTING_FEED)
    (pb / "limits" / "tiny-train.json").write_text(json.dumps({"loss_gap": 1e-3, "grad_gap": 1e-3,
                                                              "grad_diff_gap": 1e-3, "step_gap": 0.1,
                                                              "grad_diff_median": 1e-3}))
    (pb / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['steps']) if ctx.counts.get('driver') == 'counted' else None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "gwilliams2022-tiny", "source": "https://arxiv.org/abs/2208.12266",
                         "file": "port_bench/configs/gwilliams2022-tiny.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny-train", "config": "gwilliams2022-tiny", "traffic": "resident_b8",
                           "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher", "source": "program_counter",
                           "layer": "training loop", "moves": "train_segments_per_s", "workloads": ["tiny-train"]})
    for e in m["end_to_end"]:
        if "workloads" in e and e["name"] == "train_segments_per_s":
            e["workloads"].append("tiny-train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    result, _ = run_cell("tiny-train", 2**40 + 1, 1.0, True, "cpu", root=str(tmp_path), t_start=time.perf_counter())
    assert result["metrics"]["steps.train"]["value"] == result["attempted"] > 0
    assert result["correct"], result["checks"]
    assert len((pb / "feeds" / "device_resident_counted.py.count").read_text()) > result["attempted"]


def test_flop_and_roofline_counts_by_hand():
    gw = cells.Cell(CELL).config
    # mix 2·360·208·270 + shared and subject 1x1 2·(2·360·270²) + fifteen k=3 convs
    # 6·360·(270·320 + 320·320 + 320·640 + 4·(320·320 + 320·320 + 320·640)) + heads 2·360·(320·640 + 640·1024)
    mix, subject = 40_435_200, 104_976_000
    convs = 6 * 360 * (270 * 320 + 320 * 320 + 320 * 640 + 4 * (320 * 320 + 320 * 320 + 320 * 640))
    heads = 2 * 360 * (320 * 640 + 640 * 1024)
    fwd = mix + subject + convs + heads
    assert fwd == 5_153_846_400
    assert flops.encoder_forward_flops_per_row(gw) == fwd
    assert flops.train_flops_per_row(gw, 256) == fwd + 2 * fwd - mix + 3 * 2 * 256 * 360 * 1024
    assert round(flops.train_flops_per_row(gw, 256) / 1e9, 2) == 15.99
    # K2 at B=256: every conv's operations bound
    assert math.isclose(flops.k2_bound_s_per_step(gw, 256), 256 * convs / 989e12)
    assert round(flops.k2_bound_s_per_step(gw, 256) * 1e3, 3) == 1.136


def test_the_reference_agrees_with_the_port_in_f32():
    """At a small size on the CPU, the port in float32 and the plain
    reference give the same losses, gradients and parameters' change."""
    result, out = tiny_run()
    r = out["readings"]
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 and r["grad_diff_gap"] < 1e-3 and r["step_gap"] < 1e-2
    assert result["correct"], result["checks"]


def test_the_compared_steps_are_a_scan_group_of_the_window_path():
    """The first steps, which the reference follows, go through run_epoch
    as one scan group of ``tpu.scan_steps`` stacked batches, as the window's
    steps do; the window runs scan groups too."""
    calls = []

    def record(trainer):
        single, scan = trainer.train_step, trainer.train_step_scan

        def one(state, batch, *a, **k):
            calls.append(("single", batch["X"].shape[0]))
            return single(state, batch, *a, **k)

        def group(state, batches, *a, **k):
            calls.append(("scan", tuple(batches["X"].shape[:2]), tuple(k["drop_masks"].shape)))
            return scan(state, batches, *a, **k)

        trainer.train_step, trainer.train_step_scan = one, group

    result, _ = tiny_run(seconds=1.0, faults=[record])
    k = cells.Cell(CELL).config["scan_steps"]
    C = cells.Cell(CELL).config["C"]
    assert calls[0] == ("scan", (k, TINY_TRAFFIC["batch"]), (k, C))
    assert sum(c[0] == "scan" for c in calls) >= 3  # the compared group, the warm-up, the window
    assert result["correct"], result["checks"]


def test_the_compared_rows_all_differ():
    from port_bench.feeds.device_resident import Feed

    cfg = {**cells.Cell(CELL).config, **TINY_CFG}
    feed = Feed(cfg, {"batch": 16}, 7, torch.device("cpu"))
    list(feed.epoch(0, n_batches=8, distinct=True, record=True))
    ids = np.concatenate([i for i, _ in feed.drawn])
    assert len(ids) == 8 * 16 == len(set(ids.tolist()))


def test_the_batcher_is_built_as_its_constructor_builds_it(tmp_path):
    """The feed fills ``DeviceResidentGwilliams``'s fields itself, from
    stacks drawn on the device; the constructor, given a dataset of the
    same recordings as host arrays, sets the same fields and gathers the
    same batches."""
    from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams

    from port_bench.feeds.device_resident import build_batcher

    cfg = {**cells.Cell(CELL).config, **TINY_CFG}
    w = world.GwilliamsWorld(cfg, 11, "cpu")
    ds, mirror = build_batcher(w, torch.device("cpu"))
    ds.seq_len_samp = w.L
    ds.preproc_dir = str(tmp_path)
    tasks = [f"task{t}" for t in range(cfg["tasks"])]
    np.save(tmp_path / "y_dict.npy", {f"task{t}": w.Y_stack[t, :n].T.numpy() for t, n in enumerate(w.task_len)},
            allow_pickle=True)
    ds.X, ds.meg_onsets, ds.scale_stats = {}, {}, {}
    for key in w.session_keys:
        ds.X[key], ds.meg_onsets[key], ds.scale_stats[key] = {}, {}, {}
        for t, task in enumerate(tasks):
            r = w.rec_index[(key, task)]
            ds.X[key][task] = w.X_stack[r, : w.task_len[t]].T.numpy()
            ds.meg_onsets[key][task] = w.word_onsets[t] + w.shift
            ds.scale_stats[key][task] = w.stats_stack[r, : w.words[t]].numpy()
    ds.valid_subjects = np.asarray(sorted({k.split("_")[0] for k in w.session_keys}))
    ds.segment_task_ids, ds.segment_y_onsets = w.seg_task_ids, w.seg_y_onsets
    real = DeviceResidentGwilliams(ds, "float32", channels_last=True, device="cpu")
    assert set(vars(real)) == set(vars(mirror))
    rng = np.random.default_rng(3)
    ids = rng.choice(w.n_segments, size=24, replace=False)
    choices = ds.draw_choices(rng, len(ids))
    a = real.gather(real.make_index_batch(rng, ids, choices))
    b = mirror.gather(mirror.make_index_batch(rng, ids, choices))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_the_trace_names_its_metrics():
    result, _ = tiny_run(seconds=1.0, trace=True)
    assert "mfu.train" in result["metrics"]
    assert list(result)[-1] == "checks"
    # a breakdown is read only from device records, which a CPU run has none of
    assert "breakdown" not in result and result["trace_lost"] == []


def test_the_import_rule():
    assert forbidden_modules(["speech_decoding_tpu_torch", "speech_decoding_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["speech_decoding_tpu.models", "jax.numpy", "flax"]) == ["flax", "jax",
                                                                                        "speech_decoding_tpu"]
    # the reference imports only the standard library, numpy and torch
    tree = ast.parse(open(os.path.join(ROOT, "port_bench", "reference.py")).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch"}, names
    # a whole run loads neither JAX nor the JAX package
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from port_bench.test_port_bench_harness import tiny_run\n"
            "from port_bench.run import forbidden_modules\n"
            "tiny_run(seconds=0.5)\n"
            "print('FOUND', forbidden_modules())\n") % ROOT
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600,
                         cwd=ROOT)
    assert "FOUND []" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]
