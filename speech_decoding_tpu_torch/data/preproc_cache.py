"""Preprocessing cache manager.

Copy of ``speech_decoding_tpu/data/preproc_cache.py``, with the same cache-key
rules, so the two packages agree on which directory a config names and a
cache built by one loads in the other. It re-implements the reference's
check_preprocs contract [ref: speech_decoding/utils/preproc_utils.py:13-66]:
preprocessed data lives in numbered directories under
``{data_dir}/preprocessed/``, each with a ``settings.json`` snapshot of the
``preprocs`` config block (plus x_done / y_done stage flags that make
preprocessing resumable at stage granularity [ref: gwilliams2022.py:84-86,102-106]).
A directory matches when every settings key equals the requested preprocs
value (x_done/y_done and legacy keys excluded [ref: preproc_utils.py:34]).
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, Tuple

from speech_decoding_tpu_torch.utils.logging import cprint

_EXCLUDED_KEYS = ("x_done", "y_done", "preceding_chunk_for_baseline", "mode")


def _clean(settings: Dict) -> Dict:
    return {k: v for k, v in settings.items() if k not in _EXCLUDED_KEYS}


def check_preprocs(preprocs: Dict, data_dir: str) -> Tuple[Dict, str]:
    """Find or allocate the preproc directory for this ``preprocs`` config.

    Returns (flags, preproc_dir) where flags = {"x_done": bool, "y_done": bool}.
    """
    os.makedirs(data_dir, exist_ok=True)
    requested = _clean(dict(preprocs))

    for preproc_dir in sorted(glob(os.path.join(data_dir, "*/"))):
        settings_path = os.path.join(preproc_dir, "settings.json")
        try:
            with open(settings_path) as f:
                settings = json.load(f)
        except (OSError, json.JSONDecodeError):
            cprint(f"No readable settings.json under {preproc_dir}", "yellow")
            continue
        flags = {
            "x_done": bool(settings.get("x_done", False)),
            "y_done": bool(settings.get("y_done", False)),
        }
        if _clean(settings) == requested:
            cprint(f"All preproc params matched to {preproc_dir} -> using", "cyan")
            return flags, preproc_dir

    # allocate a new numbered directory
    existing = glob(os.path.join(data_dir, "*/"))
    preproc_dir = os.path.join(data_dir, str(len(existing))) + os.sep
    os.makedirs(preproc_dir, exist_ok=True)
    flags = {"x_done": False, "y_done": False}
    write_settings(preprocs, flags, preproc_dir)
    cprint("No matching preprocessing. Starting a new one.", "white")
    return flags, preproc_dir


def write_settings(preprocs: Dict, flags: Dict, preproc_dir: str) -> None:
    settings = dict(preprocs)
    settings.update(flags)
    with open(os.path.join(preproc_dir, "settings.json"), "w") as f:
        json.dump(settings, f)


def mark_done(preprocs: Dict, preproc_dir: str, stage: str) -> Dict:
    """Set x_done/y_done in settings.json (stage-resumable preprocessing)."""
    assert stage in ("x_done", "y_done")
    settings_path = os.path.join(preproc_dir, "settings.json")
    with open(settings_path) as f:
        settings = json.load(f)
    settings[stage] = True
    with open(settings_path, "w") as f:
        json.dump(settings, f)
    return {
        "x_done": bool(settings.get("x_done", False)),
        "y_done": bool(settings.get("y_done", False)),
    }
