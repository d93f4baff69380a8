"""The port stands alone: importing every module of
``speech_decoding_tpu_torch`` (and ``chip_smoke.py``) pulls in no JAX, no
flax and nothing of ``speech_decoding_tpu``, and its CLI runs as a module
where importing JAX fails; the package ships its kernel sources and
config."""

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
              "utils.reproducibility", "tools", "tools.bench_cross_block_merge", "tools.scale_run",
              "ops.fir", "ops.resample", "ops.brain_preproc_host", "ops.brain_preproc", "ops.preproc_dispatch",
              "models.wav2vec2", "models.wav2vec2_safetensors", "models.wav2vec_util", "tools.bench_preproc",
              "tools.bench_wav2vec", "utils.natsort", "utils.wavio", "data.preproc_cache", "data.synthetic",
              "data.gwilliams2022", "data.device_resident", "data.brennan2018", "train", "tools.evaluate",
              "tools.import_torch_checkpoint", "examples", "examples.synthetic_demo", "parallel",
              "parallel.mesh", "parallel.collectives", "parallel.clip_sharded", "parallel.multihost",
              "parallel.preproc_sharded", "parallel.sharding_rules", "utils.profiling", "tools.ab_int8_retrieval",
              "tools.realdata_runbook"):
        assert f"speech_decoding_tpu_torch.{m}" in mods, m
    assert len(mods) >= 65
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

    # every kernel source names the JAX file of the Pallas kernel it replaces (batchnorm_gelu.cu and
    # glu.cu, which replace none, the JAX module they run in place of and the Pallas kernel of the
    # fused path)
    replaces = {"subject_matmul.cu": ["ops/pallas/"], "conv_block.cu": ["ops/pallas/"],
                "tap_conv_dw.cu": ["ops/pallas/"], "retrieval_ranks.cu": ["ops/pallas/"],
                "tap_conv.cu": ["ops/pallas/tap_conv.py"],
                "conv_block_train.cu": ["ops/pallas/", "conv_block_train.py", "tools/bench_cross_block_merge.py"],
                "batchnorm_gelu.cu": ["models/brain_encoder.py:71", "ops/pallas/conv_block_train.py"],
                "glu.cu": ["models/brain_encoder.py:481", "ops/pallas/conv_block_train.py"],
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


def test_module_entry_point_without_jax(tmp_path):
    """``python -m speech_decoding_tpu_torch.train`` with ``import jax``
    failing: the CLI parses its arguments and reaches run, which raises
    for want of a GPU (or would train on one)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would train for real")
    code = ("import sys, runpy; sys.modules['jax'] = None; sys.argv = ['train', 'dataset=Gwilliams2022', "
            f"'root_dir={tmp_path}']; runpy.run_module('speech_decoding_tpu_torch.train', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr, out.stderr[-2000:]
    assert "jax" not in out.stderr.replace("no CUDA", ""), out.stderr[-2000:]
