"""``utils/profiling.py`` of the port against JAX's: ``StepTimer``'s
summary equals JAX's on the same patched clock (``tests/test_utils.py``'s
test), ``trace`` writes a ``torch.profiler`` trace on the CPU and is a
no-op for a falsy directory, and ``annotate``'s name appears among the
trace's events."""

import pytest

torch = pytest.importorskip("torch")

import glob  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from speech_decoding_tpu_torch.utils import profiling  # noqa: E402


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("items", [1, 4])
def test_step_timer_summary_equals_jax(monkeypatch, items):
    from speech_decoding_tpu.utils.profiling import StepTimer as JaxStepTimer

    # start/stop pairs 0.5, 1.0, ..., 2.5 s apart
    ticks = list(itertools.chain.from_iterable((10.0 * i, 10.0 * i + 0.5 * (i + 1)) for i in range(5)))
    summaries = []
    for cls in (JaxStepTimer, profiling.StepTimer):
        _clock(monkeypatch, ticks)
        t = cls()
        for _ in range(5):
            t.start()
            t.stop(items=items)
        summaries.append(t.summary(items_per_step=items))
    assert summaries[0] == summaries[1]
    assert summaries[1]["steps"] == 5 and summaries[1]["items_per_sec"] == pytest.approx(items * 5 / 7.5)
    assert profiling.StepTimer().summary() == {}


def test_step_timer_stop_before_start_raises():
    with pytest.raises(RuntimeError, match="before start"):
        profiling.StepTimer().stop()


def test_trace_writes_a_file_with_the_annotation(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.annotate("grid_all_gather"):
            (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "grid_all_gather" in names
    assert "grid_all_gather" in {e.name for e in prof.events()}


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("region"):
            pass
    assert prof is None and list(tmp_path.iterdir()) == []
