"""The comparison that decides ``correct`` has to fail where the program
is wrong: the control (the reference in the precision below the
configuration's, in the program's place) and each fault a cell can have,
planted under the timed path, make ``correct`` false under the cell's own
limits. At a small size on the CPU; ``python -m port_bench.calibrate``
reads the same at the cells' sizes on the card."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from port_bench import cells, check, faults  # noqa: E402
from port_bench.test_port_bench_harness import CELL, tiny_run  # noqa: E402


def test_the_control_fails_under_the_cells_limits():
    _, out = tiny_run(seconds=0.0, f32=False)
    ok, checks = check.judge(out["control"](), cells.Cell(CELL).limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", [faults.state_unchanged, faults.half_batch])
def test_a_planted_fault_makes_correct_false(fault):
    sound, _ = tiny_run(seconds=0.0)
    assert sound["correct"], sound["checks"]
    broken, _ = tiny_run(seconds=0.0, faults=[fault])
    assert not broken["correct"], broken["checks"]
