"""The port stands alone: importing every module of
``speech_decoding_tpu_torch`` (and ``chip_smoke.py``) pulls in no JAX, no
flax and nothing of ``speech_decoding_tpu``; the package ships its kernel
sources and config."""

import pytest

pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "speech_decoding_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("ops.conv_block", "ops.scaling", "ops.tap_conv", "ops.retrieval", "models.loss",
              "models.classifier", "training", "training.state", "training.steps", "training.trainer",
              "training.checkpoint", "training.preemption", "data.sampling", "data.native_loader",
              "utils.reproducibility", "tools", "tools.bench_cross_block_merge", "tools.scale_run"):
        assert f"speech_decoding_tpu_torch.{m}" in mods, m
    assert len(mods) >= 33
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'speech_decoding_tpu'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_kernel_sources_and_config_ship_with_the_package():
    from speech_decoding_tpu_torch.config import load_config
    from speech_decoding_tpu_torch.ops import _build

    # every kernel source names the JAX file of the Pallas kernel it replaces
    replaces = {"subject_matmul.cu": ["ops/pallas/"], "conv_block.cu": ["ops/pallas/"],
                "tap_conv_dw.cu": ["ops/pallas/"], "retrieval_ranks.cu": ["ops/pallas/"],
                "tap_conv.cu": ["ops/pallas/tap_conv.py"],
                "conv_block_train.cu": ["ops/pallas/", "conv_block_train.py", "tools/bench_cross_block_merge.py"],
                "tap3.cuh": ["ops/pallas/", "conv_block.py:50", "ops/pallas/tap_conv.py"],
                "hopper.cuh": ["ops/pallas/tap_conv.py"],
                "conv_wg.cuh": ["ops/pallas/", "conv_block.py:50", "conv_block_train.py"]}
    assert sorted(replaces) == sorted(os.listdir(_build.SRC_DIR))
    for name, files in replaces.items():
        with open(os.path.join(_build.SRC_DIR, name)) as f:
            text = f.read()
        assert name.endswith(".cuh") or 'extern "C"' in text, name
        for jax_file in files:
            assert jax_file in text, (name, jax_file)
    cfg = load_config()
    assert cfg.D1 == 270 and cfg.D2 == 320 and cfg.K == 32


def test_chip_smoke_refuses_without_a_gpu():
    """Without a CUDA device the script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
