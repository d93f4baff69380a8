"""``utils/profiling.py`` of the port: ``trace`` writes a ``torch.profiler``
trace on the CPU and is a no-op for a falsy directory; ``annotate`` is free
while no profiler records and, while one does, a ``record_function`` range
and an entry in the span log on the profiler's clock, from any thread; the
log is bounded; and the training loop, the train step and the
device-resident batcher open their spans where their work happens."""

import pytest

torch = pytest.importorskip("torch")

import glob  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from speech_decoding_tpu_torch.utils import profiling  # noqa: E402


def _host_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.profiler.kineto_results.events() if e.device_type() != cuda]


@pytest.fixture
def log():
    profiling.clear_span_log()
    yield profiling.span_log()
    profiling.clear_span_log()


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


def test_annotate_without_a_profiler_opens_nothing(monkeypatch, log):
    """No profiler recording: one shared null context, no record_function,
    no clock read, nothing logged."""

    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(time, "time_ns", refuse)
    assert profiling.annotate(profiling.STEP) is profiling.annotate(profiling.LOOP_WAIT)
    with profiling.annotate(profiling.STEP):
        (torch.ones(4) * 2).sum()
    assert log.spans() == [] and log.dropped == 0


def test_a_span_is_logged_on_the_profilers_clock(tmp_path, log):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("sd.test.main"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    (span,) = log.spans()
    assert span.name == "sd.test.main" and span.thread == threading.main_thread().name
    assert span.start_ns < span.end_ns
    (event,) = [e for e in _host_events(prof) if e.name() == "sd.test.main"]
    assert abs(span.start_ns - event.start_ns()) < 1_000_000
    assert abs(span.end_ns - (event.start_ns() + event.duration_ns())) < 1_000_000


def test_a_thread_started_inside_the_profile_is_logged_not_traced(tmp_path, log):
    """torch.profiler records only the thread that started it: a span of a
    thread started inside the profile is in the log alone."""

    def work():
        with profiling.annotate("sd.test.thread"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()

    with profiling.trace(str(tmp_path)) as prof:
        t = threading.Thread(target=work, name="sd-test-worker")
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert [(s.name, s.thread) for s in log.spans()] == [("sd.test.thread", "sd-test-worker")]
    assert "sd.test.thread" not in {e.name() for e in _host_events(prof)}


def test_the_span_log_drops_the_oldest_and_counts_them(tmp_path, monkeypatch):
    small = profiling.SpanLog(maxlen=3)
    monkeypatch.setattr(profiling, "_LOG", small)
    with profiling.trace(str(tmp_path)):
        for i in range(5):
            with profiling.annotate(f"sd.test.{i}"):
                pass
    assert profiling.span_log() is small
    assert [s.name for s in small.spans()] == ["sd.test.2", "sd.test.3", "sd.test.4"] and small.dropped == 2
    profiling.clear_span_log()
    assert small.spans() == [] and small.dropped == 0


def test_the_span_table():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS) == 9
    assert all(n.startswith("sd.") for n in profiling.SPANS)


def _within(inner, outer):
    return inner.thread == outer.thread and outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_the_trainer_epoch_opens_its_spans(tmp_path, log):
    """Scan groups of 2 over 5 batches (2 groups, 1 single step): an
    ``sd.step`` a step with its forward, backward and optimizer inside it,
    an ``sd.loop.stack`` a group in the Prefetcher's thread, and the loop's
    waits for a batch in the main thread."""
    from speech_decoding_tpu_torch.config import load_config
    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.training import Trainer

    S, F, T, C = 2, 16, 24, 208
    enc = BrainEncoder(num_subjects=S, loc=ch_locations_2d("Gwilliams2022", cache=False), D1=8, D2=8, F=F, K=2,
                       generator=torch.Generator().manual_seed(0))
    cfg = load_config()
    for path, value in {"tpu.compute_dtype": "float32", "tpu.scan_steps": 2, "epochs": 1}.items():
        cfg.set_path(path, value)
    rng = np.random.default_rng(0)
    batches = [{"X": rng.normal(size=(8, C, T)).astype(np.float32), "Y": rng.normal(size=(8, F, T)).astype(np.float32),
                "subject_idxs": rng.integers(0, S, 8).astype(np.int32)} for _ in range(5)]
    trainer = Trainer(enc, cfg, device="cpu")
    with profiling.trace(str(tmp_path)):
        trainer.run_epoch(0, batches, None)
    spans = log.spans()
    by = {n: [s for s in spans if s.name == n] for n in profiling.SPANS}
    main = threading.main_thread().name
    assert len(by[profiling.STEP]) == trainer.state.step == 5
    assert {s.thread for s in by[profiling.STEP]} == {main}
    for part in (profiling.STEP_FORWARD, profiling.STEP_BACKWARD, profiling.STEP_OPTIMIZER):
        assert len(by[part]) == 5
        assert all(any(_within(s, step) for step in by[profiling.STEP]) for s in by[part]), part
    assert by[profiling.STEP_GRAPH] == []  # CPU tensors: every step eager
    assert [s.thread for s in by[profiling.LOOP_STACK]] == ["sd-prefetch"] * 2
    assert by[profiling.LOOP_WAIT] and {s.thread for s in by[profiling.LOOP_WAIT]} == {main}


class _TinyGwilliams:
    """The fields of a built Gwilliams2022 dataset that
    ``DeviceResidentGwilliams`` reads: two sessions of one task, four
    words."""

    seq_len_samp = 6

    def __init__(self, root, C=5, F=3):
        rng = np.random.default_rng(1)
        self.preproc_dir = str(root)
        np.save(root / "y_dict.npy", {"task0": rng.normal(size=(F, 40)).astype(np.float32)}, allow_pickle=True)
        keys = ["s0_0", "s1_0"]
        self.X = {k: {"task0": rng.normal(size=(C, 50)).astype(np.float32)} for k in keys}
        self.meg_onsets = {k: {"task0": np.array([0, 8, 16, 30])} for k in keys}
        self.scale_stats = {k: {"task0": rng.normal(size=(4, C, 2)).astype(np.float32)} for k in keys}
        self.valid_subjects = np.array(["s0", "s1"])
        self.segment_task_ids = np.zeros(4, np.int64)
        self.segment_y_onsets = np.array([0, 7, 15, 28])

    def segment_to_task(self, i):
        return i, "task0"

    def draw_choices(self, rng, n):
        return rng.integers(0, len(self.X), n)


def test_the_resident_batcher_opens_a_span_a_batch(tmp_path, log):
    from speech_decoding_tpu_torch.data.device_resident import DeviceResidentGwilliams

    batcher = DeviceResidentGwilliams(_TinyGwilliams(tmp_path), channels_last=True, device="cpu")
    rng = np.random.default_rng(2)
    with profiling.trace(str(tmp_path / "trace")):
        for _ in range(3):
            out = batcher.gather(batcher.make_index_batch(rng, np.array([0, 2, 3])))
    assert tuple(out["X"].shape) == (3, 6, 5)
    names = [s.name for s in log.spans()]
    assert names == [profiling.DATA_INDEX, profiling.DATA_GATHER] * 3
