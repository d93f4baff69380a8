"""The real-data run of the port as one command: probe what it needs, report
each blocked step with its prerequisite, and run the steps that are ready.

Port of ``tools/realdata_runbook.py``:

    python -m speech_decoding_tpu_torch.tools.realdata_runbook            # dry run: probe and report
    python -m speech_decoding_tpu_torch.tools.realdata_runbook --execute  # run every ready step

Steps, each probed on its own:

  A. MNE-exact sensor layouts: ``data.layout.ch_locations_2d`` computes and
     caches them when ``mne`` imports (Gwilliams also needs ``mne_bids``
     and its BIDS tree) [ref: utils/layout.py:9-32];
  B. pretrained xlsr-53 weights: a local ``model.safetensors``
     (``W2V_SAFETENSORS``, ``<root>/weights/*.safetensors`` or the Hugging
     Face cache), loaded by ``models.wav2vec_util.load_wav2vec_model``
     [ref: utils/wav2vec_util.py:8-11];
  C. the dataset caches: the port's CLI with ``rebuild_dataset=True`` on
     the raw recordings and stimuli, with step B's weights;
  D. training to convergence and the parity eval (``tools.evaluate`` on the
     best checkpoint; with ``REF_CHECKPOINT=<model_last.pt>`` a
     reference-trained checkpoint beside it, |ours − ref| top-10 <= 1%)
     [ref: train.py:211-243].

Nothing is downloaded and no network is probed: the port loads weights from
local files only, so a reachable hub would make no step ready. Exit code:
0 for a dry run (a blocked step is a finding, not a failure); with
``--execute``, nonzero iff a ready step failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from glob import glob
from typing import Callable, List, Optional

from speech_decoding_tpu_torch.utils.logging import cprint

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT_DIR = os.path.join("outputs", "runbook", "checkpoints")  # under the data root


def have_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def find_safetensors(root: str) -> Optional[str]:
    """A local xlsr-53 ``model.safetensors``: ``W2V_SAFETENSORS``, then
    ``<root>/weights/*.safetensors``, then the Hugging Face hub cache."""
    cands = [os.environ.get("W2V_SAFETENSORS", "")]
    cands += sorted(glob(os.path.join(root, "weights", "*.safetensors")))
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    cands += sorted(glob(os.path.join(hf_home, "hub", "models--facebook--wav2vec2-large-xlsr-53", "snapshots", "*",
                                      "model.safetensors")))
    return next((c for c in cands if c and os.path.exists(c)), None)


@dataclass
class Step:
    key: str
    title: str
    ready: bool
    why: str  # the prerequisite, reported when blocked
    run: Callable[[], bool]


def _cli(module: str, *args: str, capture: bool = False) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", f"speech_decoding_tpu_torch.{module}", *args]
    print("  $ " + " ".join(cmd))
    return subprocess.run(cmd, cwd=REPO, capture_output=capture, text=True)


def build_steps(root: str) -> List[Step]:
    have_mne, have_mne_bids = have_module("mne"), have_module("mne_bids")
    st_path = find_safetensors(root)
    br_raw = sorted(glob(os.path.join(root, "data", "Brennan2018", "raw", "*.mat")))
    br_wav = sorted(glob(os.path.join(root, "data", "Brennan2018", "audio", "*.wav")))
    gw_root = os.path.join(root, "data", "Gwilliams2022")
    gw_bids = sorted(glob(os.path.join(gw_root, "sub-*"))) or sorted(glob(os.path.join(gw_root, "download", "sub-*")))
    gw_stimuli = (sorted(glob(os.path.join(gw_root, "stimuli", "audio", "*.wav")))
                  or sorted(glob(os.path.join(gw_root, "download", "stimuli", "audio", "*.wav"))))
    present = {"Brennan2018": bool(br_raw and br_wav), "Gwilliams2022": bool(gw_bids and gw_stimuli)}
    data_why = (f"needs raw data: data/Brennan2018/{{raw/*.mat,audio/*.wav}} (found {len(br_raw)} mats, "
                f"{len(br_wav)} wavs) or the data/Gwilliams2022/sub-* BIDS tree (found {len(gw_bids)} subjects, "
                f"{len(gw_stimuli)} stimuli)")

    def run_layouts() -> bool:
        from speech_decoding_tpu_torch.data.layout import ch_locations_2d

        for ds in ("Brennan2018", "Gwilliams2022"):
            if ds == "Gwilliams2022" and not (have_mne_bids and gw_bids):
                print(f"  {ds}: skipped (needs mne_bids and the BIDS tree)")
                continue
            print(f"  {ds}: {ch_locations_2d(ds, root).shape[0]} sensors cached under data/{ds}")
        return True

    def run_weights() -> bool:
        from speech_decoding_tpu_torch.models.wav2vec_util import load_wav2vec_model

        model = load_wav2vec_model(st_path)  # on the card, as every entry point
        n = sum(p.numel() for p in model.model.parameters())
        print(f"  loaded {st_path}: {n / 1e6:.0f}M parameters")
        return n > 300e6  # xlsr-53 has ~315M

    def run_rebuild() -> bool:
        ok = True
        for ds in (d for d, here in present.items() if here):
            ok &= _cli("train", f"dataset={ds}", "rebuild_dataset=True", "epochs=0", f"root_dir={root}",
                       f"wav2vec_model={st_path}").returncode == 0
        return ok

    def run_parity() -> bool:
        ds = "Gwilliams2022" if present["Gwilliams2022"] else "Brennan2018"
        common = [f"dataset={ds}", f"root_dir={root}"]
        if _cli("train", *common, f"checkpoint.dir={CKPT_DIR}").returncode != 0:
            return False
        ev = _cli("tools.evaluate", *common, f"checkpoint.dir={CKPT_DIR}", "eval.best=true", capture=True)
        print("  " + ev.stdout.strip())
        if ev.returncode != 0:
            print("  " + ev.stderr.strip()[-500:])
            return False
        ours = json.loads(ev.stdout.strip().splitlines()[-1])
        ref_ckpt = os.environ.get("REF_CHECKPOINT", "")
        if not (ref_ckpt and os.path.exists(ref_ckpt)):
            print("  (set REF_CHECKPOINT=<model_last.pt> to compare against a reference-trained model)")
            return True
        rv = _cli("tools.evaluate", *common, f"torch_checkpoint={ref_ckpt}", capture=True)
        if rv.returncode != 0:
            print("  " + rv.stderr.strip()[-500:])
            return False
        gap = abs(ours["top10"] - json.loads(rv.stdout.strip().splitlines()[-1])["top10"])
        print(f"  top-10 gap against the reference checkpoint: {gap:.4f}")
        return gap <= 0.01

    weights_why = "needs weights/model.safetensors (or W2V_SAFETENSORS=<path>); nothing is downloaded"
    return [
        Step("A", "MNE-exact sensor layouts", have_mne,
             "needs `pip install mne`" + ("" if have_mne_bids else " (and mne_bids for Gwilliams)"), run_layouts),
        Step("B", "pretrained xlsr-53 weights", st_path is not None, weights_why, run_weights),
        Step("C", "dataset cache rebuild", any(present.values()) and st_path is not None,
             data_why + ("" if st_path else "; and step B's weights"), run_rebuild),
        Step("D", "train + parity eval (north star)", any(present.values()) and st_path is not None,
             "blocked by step C's prerequisites", run_parity),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--execute", action="store_true", help="run the ready steps (default: a dry-run report)")
    ap.add_argument("--root", default=REPO, help="data root (expects <root>/data/<Dataset>/...)")
    args = ap.parse_args(argv)

    steps = build_steps(args.root)
    cprint(f"north-star runbook [{'EXECUTE' if args.execute else 'DRY-RUN'}] root={args.root}", "cyan")
    failed = False
    for s in steps:
        if not s.ready:
            cprint(f"[{s.key}] {s.title}: BLOCKED: {s.why}", "yellow")
            continue
        if not args.execute:
            cprint(f"[{s.key}] {s.title}: READY", "green")
            continue
        cprint(f"[{s.key}] {s.title}: running", "cyan")
        try:
            ok = s.run()
        except Exception as e:  # a failed step is reported and the later steps still run
            print(f"  {type(e).__name__}: {e}")
            ok = False
        cprint(f"[{s.key}] {s.title}: {'OK' if ok else 'FAILED'}", "green" if ok else "red")
        failed |= not ok
    blocked = [s.key for s in steps if not s.ready]
    if blocked:
        cprint(f"blocked: {', '.join(blocked)}; each blocked step above names its prerequisite", "yellow")
    return 1 if (args.execute and failed) else 0


if __name__ == "__main__":
    raise SystemExit(main())
