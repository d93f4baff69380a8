"""Finds what a cell is made of by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file, its limits file, the driver and
the feed its traffic names, and the reader of each per-layer metric. A
later change adds a cell, a configuration, a traffic mix, a driver, a feed
or a metric as new files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with its configuration, traffic, limits
    and metric names."""

    def __init__(self, name: str, root: str = ROOT):
        m = manifest(root)
        self.root = root
        self.workload = _by_name(m["workloads"], name, "workload")
        self.name = name
        entry = _by_name(m["configs"], self.workload["config"], "config")
        self.config = _load_json(os.path.join(root, entry["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = _load_json(os.path.join(root, "port_bench", "traffic", f"{self.traffic_name}.json"))
        self.chips = int(self.workload["chips"])

        def reported(metric: Dict) -> bool:
            return name in metric.get("workloads", [name])

        self.end_to_end = [e for e in m["end_to_end"] if reported(e)]
        e2e_names = {e["name"] for e in self.end_to_end}
        self.per_layer = [p for p in m["per_layer"] if reported(p) and p["moves"] in e2e_names]
        lim = os.path.join(root, "port_bench", "limits", f"{name}.json")
        self.limits: Optional[Dict[str, float]] = _load_json(lim) if os.path.exists(lim) else None


def load(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """The module ``port_bench/<kind>/<name>.py``: a driver (``drivers``,
    named by a traffic file's ``driver``), a feed (``feeds``, named by its
    ``feed``) or a metric's reader (``metrics``)."""
    path = os.path.join(root, "port_bench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read(ctx) -> float or None`` of the per-layer metric ``name``."""
    return load("metrics", name, root).read
