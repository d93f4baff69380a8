"""The comparisons that decide ``correct``: each number compared, beside
its limit from ``port_bench/limits/<cell>.json``.

Training: the loss of each of the first steps, the gradient Adam got at its
first update (from its first moment, m = (1 − β1)·g) and the parameters'
change over the first steps, each leaf's norm against the reference's, by
the worst leaf; and that gradient's difference from the reference's, by
the worst leaf and by the median leaf: rounding moves a gradient's
direction far more than its norm, so the norms alone do not separate the
control from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

ADAM_B1 = 0.9


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double().cpu()))


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep: List[str],
               of_difference: bool = False) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| (or ‖prog − ref‖) over max(‖ref‖, the
    median leaf's ‖ref‖)."""
    rn = {n: _norm(ref[n]) for n in keep}
    med = float(np.median(list(rn.values())))
    if of_difference:
        num = {n: _norm(prog[n].double().cpu() - ref[n].double().cpu()) for n in keep}
    else:
        num = {n: abs(_norm(prog[n]) - rn[n]) for n in keep}
    return {n: num[n] / max(rn[n], med, 1e-30) for n in keep}


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others (a conv bias feeding a batch-statistics BatchNorm)
    move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g.double().cpu())) for n, g in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def train_gaps(prog_losses: List[float], ref_losses: List[float], prog_grad: Dict, ref_grad: Dict,
               p0: Dict, prog_after: Dict, ref_after: Dict) -> Dict[str, Dict[str, float]]:
    """Each number's gap by step (losses) or by leaf (the rest)."""
    keep = kept_leaves(ref_grad)
    d_prog = {n: prog_after[n].double().cpu() - p0[n].double().cpu() for n in keep}
    d_ref = {n: ref_after[n].double().cpu() - p0[n].double().cpu() for n in keep}
    return {
        "loss_gap": {f"step{i}": (abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                     for i, (a, b) in enumerate(zip(prog_losses, ref_losses))},
        "grad_gap": _leaf_gaps(prog_grad, ref_grad, keep),
        "grad_diff_gap": _leaf_gaps(prog_grad, ref_grad, keep, of_difference=True),
        "step_gap": _leaf_gaps(d_prog, d_ref, keep),
    }


def train_readings(*args) -> Dict[str, float]:
    """The worst step or leaf of each number of ``train_gaps``, and the
    median leaf's gradient difference."""
    return summarize(train_gaps(*args))


def summarize(gaps: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    out = {k: max(v.values()) for k, v in gaps.items()}
    out["grad_diff_median"] = float(np.median(list(gaps["grad_diff_gap"].values())))
    return out


def worst(gaps: Dict[str, Dict[str, float]]) -> Dict[str, str]:
    return {k: max(v, key=v.get) for k, v in gaps.items()}


def judge(readings: Dict[str, float], limits: Optional[Dict[str, float]]) -> (bool, Dict[str, Dict]):
    """(correct, {name: {value, limit}}): every reading at or under its
    limit. Without limits nothing is correct."""
    out = {n: {"value": v, "limit": (limits or {}).get(n)} for n, v in readings.items()}
    ok = limits is not None and all(
        o["limit"] is not None and math.isfinite(o["value"]) and o["value"] <= o["limit"] for o in out.values())
    return ok, out
