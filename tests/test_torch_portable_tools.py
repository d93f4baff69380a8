"""The last two portable tools of the JAX package, in the port:

  * ``tools/ab_int8_retrieval.py``: the port's int8 contraction (the bank
    upcast a chunk of rows at a time), the whole-bank upcast and the int8 ×
    int8 → int32 route over chunks of D, at small N and D (chunks of 256
    terms, so D = 1000 spans four), against JAX's ``retrieve_topk_int8``
    and each other: the same ids, scores within 1e-5; the packed layout;
    the A/B's record on the CPU;
  * ``tools/realdata_runbook.py``: the dry run and ``--execute`` exit 0 and
    report every step blocked with its prerequisite here (no ``mne``, no
    weights, no recordings), and open no socket; a step made ready runs
    under ``--execute`` only, and a failing ready step makes it exit 1."""

import pytest

torch = pytest.importorskip("torch")

import socket  # noqa: E402

import numpy as np  # noqa: E402

from speech_decoding_tpu_torch.inference import quantize_rows_int8, retrieve_topk_int8  # noqa: E402
from speech_decoding_tpu_torch.tools import ab_int8_retrieval as ab  # noqa: E402
from speech_decoding_tpu_torch.tools import realdata_runbook as runbook  # noqa: E402

N, DIM, BATCH, CHUNK = 96, 1000, 24, 256


def _bank_and_queries():
    rng = np.random.default_rng(21)
    rows = rng.normal(size=(N, DIM)).astype(np.float32)
    bank = rows / np.linalg.norm(rows, axis=-1, keepdims=True)
    # queries near bank rows, so the top ids are well separated
    Z = (bank[rng.integers(0, N, BATCH)] + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
    return bank, Z


def test_pack_int8_bank_layout():
    q = torch.arange(3 * 10, dtype=torch.int8).reshape(3, 10)
    q3 = ab.pack_int8_bank(q, 4)
    assert q3.shape == (3, 3, 4) and q3.dtype == torch.int8
    assert torch.equal(q3.transpose(0, 1).reshape(3, 12)[:, :10], q)
    assert not q3[2, :, 2:].any()


@pytest.mark.parametrize("route", ["port", "whole", "int32"])
def test_int8_routes_match_jax(route):
    import jax.numpy as jnp

    from speech_decoding_tpu.inference import quantize_rows_int8 as j_quantize, retrieve_topk_int8 as j_retrieve

    bank, Z = _bank_and_queries()
    jq, jscale = j_quantize(jnp.asarray(bank))
    want_scores, want_ids = (np.asarray(a) for a in j_retrieve(jnp.asarray(Z), jq, jscale, k=10))
    q, scale = quantize_rows_int8(torch.from_numpy(bank))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    Zt = torch.from_numpy(Z)
    if route == "port":
        scores, ids = retrieve_topk_int8(Zt, q, scale, 10)
    elif route == "whole":
        scores, ids = ab.retrieve_topk_int8_whole(Zt, q, scale, 10)
    else:
        scores, ids = ab.retrieve_topk_int8_int32(Zt, ab.pack_int8_bank(q, CHUNK), scale, 10)
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=0, atol=1e-5)


def test_ab_record_on_the_cpu():
    out = ab.ab(64, batch=8, dim=DIM, device="cpu", reps=1)
    assert out["device"] == "cpu" and (out["N"], out["D"], out["B"]) == (64, DIM, 8)
    for name in ("whole", "int32", "f32"):
        assert out[f"{name}_ms"] > 0
    assert out["whole_top1_agreement"] == out["int32_top1_agreement"] == 1.0
    assert out["whole_max_score_diff"] <= 1e-5 and out["int32_max_score_diff"] <= 1e-5


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the runbook opened a network connection")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.delenv("W2V_SAFETENSORS", raising=False)


@pytest.mark.parametrize("execute", [False, True])
def test_runbook_reports_every_step_blocked(tmp_path, monkeypatch, capsys, no_network, execute):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setattr(runbook, "have_module", lambda name: False)
    rc = runbook.main(["--root", str(tmp_path)] + (["--execute"] if execute else []))
    out = capsys.readouterr().out
    assert rc == 0
    for key, prereq in (("A", "pip install mne"), ("B", "model.safetensors"), ("C", "needs raw data"),
                        ("D", "step C's prerequisites")):
        assert f"[{key}]" in out and prereq in out, key
    assert out.count("BLOCKED") == 4 and "blocked: A, B, C, D" in out


def test_runbook_runs_ready_steps_only_under_execute(tmp_path, monkeypatch, capsys, no_network):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setattr(runbook, "have_module", lambda name: name == "mne")
    ran = []

    def fake_steps(root):
        steps = [runbook.Step("A", "layouts", True, "", lambda: ran.append("A") or True),
                 runbook.Step("B", "weights", False, "needs weights", lambda: ran.append("B") or True),
                 runbook.Step("C", "rebuild", True, "", lambda: ran.append("C") or False)]
        return steps

    monkeypatch.setattr(runbook, "build_steps", fake_steps)
    assert runbook.main(["--root", str(tmp_path)]) == 0 and ran == []
    assert runbook.main(["--root", str(tmp_path), "--execute"]) == 1 and ran == ["A", "C"]
    out = capsys.readouterr().out
    assert "[A] layouts: OK" in out and "[C] rebuild: FAILED" in out and "[B] weights: BLOCKED" in out


def test_runbook_finds_local_weights(tmp_path, monkeypatch, no_network):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert runbook.find_safetensors(str(tmp_path)) is None
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "model.safetensors").write_bytes(b"")
    assert runbook.find_safetensors(str(tmp_path)) == str(tmp_path / "weights" / "model.safetensors")
    steps = {s.key: s for s in runbook.build_steps(str(tmp_path))}
    assert steps["B"].ready and not steps["C"].ready
