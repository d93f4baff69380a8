"""CPU test of the program-span metrics in a whole traced run: a tiny
``gw208-train-b256-resident`` run reports the host-span metrics beside
``mfu.train``; the two idle shares, like ``device_idle_share.train`` and
``K2_roofline.train``, need device operations and are left out on the CPU.
Run with ``python -m pytest port_bench -q``."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from port_bench.test_port_bench_harness import tiny_run  # noqa: E402

HOST = ["host_step_ms.train", "host_forward_ms.train", "host_backward_ms.train", "host_optimizer_ms.train",
        "stack_ms.train", "data_ms.train"]


def test_a_traced_run_reports_the_span_metrics():
    result, out = tiny_run(seconds=1.0, trace=True)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == {"mfu.train", *HOST}, sorted(m)
    assert all(m[k] > 0 for k in HOST)
    assert m["host_forward_ms.train"] + m["host_backward_ms.train"] + m["host_optimizer_ms.train"] <= \
        m["host_step_ms.train"]
    assert result["metrics"]["host_step_ms.train"]["unit"] == "ms"
    assert not any(name.startswith("sd.") for name, _, _ in out["trace"].device_events)
    assert result["correct"], result["checks"]
