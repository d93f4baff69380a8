"""2-D sensor geometry for spatial attention.

Re-implements the reference's ch_locations_2d
[ref: speech_decoding/utils/layout.py:6-43]: Brennan2018 uses the easycap-M10
EEG montage 2-D layout with broken channel 29 removed -> (60, 2); Gwilliams2022
uses the MEG layout of the first BIDS recording -> (208, 2). Both are min-max
normalized and scaled into [0.1, 0.9] (the spatial-attention bases are
periodic, so a 0.1 margin is kept on each side [ref: layout.py:40-41]).

TPU-first design: the layout is *static data*, precomputed once host-side and
cached on disk, so training needs no MNE dependency. The cache is an ``.npz``
(``{root_dir}/data/{dataset}/layout_2d.npz``) carrying a ``source`` provenance
field (``"mne"`` or ``"fallback"``). Resolution order:

  1. an MNE-provenance cache is trusted and served silently;
  2. a fallback-provenance cache (or a legacy provenance-less ``layout_2d.npy``)
     triggers an MNE retry first — if MNE is now importable the exact layout is
     computed and the cache upgraded; otherwise the cached fallback is served
     WITH a warning (every call, so an inexact layout is never silent);
  3. no cache: MNE/mne_bids if importable (exactly the reference recipe,
     cached as source="mne"), else a documented geometric fallback (ring
     layout for easycap-M10, sunflower spiral for the 208-sensor KIT MEG
     system), cached as source="fallback". The fallback preserves the
     interface and the [0.1, 0.9] box but is NOT position-exact; regenerate
     the cache with MNE installed (tools/precompute_layout.py) before
     comparing accuracy against the reference.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Optional

import numpy as np

from speech_decoding_tpu_torch.utils.logging import cprint

NUM_CHANNELS = {"Brennan2018": 60, "Gwilliams2022": 208}


def _normalize(loc: np.ndarray) -> np.ndarray:
    """min-max normalize then keep a 0.1 margin [ref: layout.py:38-41]."""
    loc = (loc - loc.min(axis=0)) / (loc.max(axis=0) - loc.min(axis=0))
    return (loc * 0.8 + 0.1).astype(np.float32)


def _easycap_m10_fallback() -> np.ndarray:
    """Ring approximation of the easycap-M10 equidistant 61-electrode montage:
    concentric rings of 1/6/12/18/24 electrodes around the vertex. Channel 29
    (index 28) is removed as in the reference [ref: layout.py:17-18]."""
    counts = [1, 6, 12, 18, 24]
    pts = []
    for ring, count in enumerate(counts):
        r = ring / (len(counts) - 1)
        for i in range(count):
            theta = 2 * np.pi * i / count + (np.pi / count if ring % 2 else 0.0)
            pts.append((r * np.cos(theta), r * np.sin(theta)))
    loc = np.asarray(pts, np.float64)  # (61, 2)
    loc = np.delete(loc, 28, axis=0)  # (60, 2)
    return loc


def _kit208_fallback() -> np.ndarray:
    """Sunflower-spiral approximation of the 208-sensor KIT MEG helmet."""
    n = 208
    golden = np.pi * (3 - np.sqrt(5))
    i = np.arange(n, dtype=np.float64)
    r = np.sqrt((i + 0.5) / n)
    theta = golden * i
    return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1)


def _try_mne(dataset_name: str, root_dir: str) -> Optional[np.ndarray]:
    """The exact reference recipe, when MNE is available [ref: layout.py:9-32]."""
    try:
        import mne
    except ImportError:
        return None
    mne.set_log_level(verbose="WARNING")
    if dataset_name == "Brennan2018":
        montage = mne.channels.make_standard_montage("easycap-M10")
        info = mne.create_info(ch_names=montage.ch_names, sfreq=512.0, ch_types="eeg")
        info.set_montage(montage)
        layout = mne.channels.find_layout(info, ch_type="eeg")
        loc = layout.pos[:, :2]
        loc = np.delete(loc, 28, axis=0)  # broken channel 29
        return loc
    if dataset_name == "Gwilliams2022":
        try:
            import mne_bids
        except ImportError:
            return None
        bids_path = mne_bids.BIDSPath(
            subject="01",
            session="0",
            task="0",
            datatype="meg",
            root=f"{root_dir}/data/Gwilliams2022/",
        )
        raw = mne_bids.read_raw_bids(bids_path)
        layout = mne.channels.find_layout(raw.info, ch_type="meg")
        return layout.pos[:, :2]
    raise ValueError(f"Unknown dataset: {dataset_name}")


def _load_cached(cache_dir: str, n_ch: int):
    """Return (loc, source) from the on-disk cache, or (None, None).

    The current format is ``layout_2d.npz`` with a ``source`` provenance field;
    a legacy provenance-less ``layout_2d.npy`` is read as source="unknown" so
    it is never silently trusted as position-exact.
    """
    # tolerant loads: a concurrent writer (multi-host startup on a shared
    # filesystem) may be mid-upgrade — a torn/vanished cache file is treated
    # as "no cache", never a crash
    # (BadZipFile/EOFError: a truncated npz/npy is "torn", not an error state)
    torn = (FileNotFoundError, OSError, ValueError, KeyError,
            EOFError, zipfile.BadZipFile)
    npz_path = os.path.join(cache_dir, "layout_2d.npz")
    try:
        with np.load(npz_path, allow_pickle=False) as z:
            loc, source = z["loc"], str(z["source"])
        if loc.shape != (n_ch, 2):  # ValueError: in `torn`, unlike an assert
            raise ValueError(f"cached layout shape {loc.shape} != ({n_ch}, 2)")
        return loc.astype(np.float32), source
    except torn:
        pass
    try:
        loc = np.load(os.path.join(cache_dir, "layout_2d.npy"))
        if loc.shape != (n_ch, 2):
            raise ValueError(f"cached layout shape {loc.shape} != ({n_ch}, 2)")
        return loc.astype(np.float32), "unknown"
    except torn:
        pass
    return None, None


def _write_cache(cache_dir: str, loc: np.ndarray, source: str) -> bool:
    """Atomically write the tagged cache (temp file + rename, safe under
    concurrent multi-host writers). Returns False if the write failed."""
    tmp = None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        final = os.path.join(cache_dir, "layout_2d.npz")
        # mkstemp: unique per writer even across hosts sharing a filesystem
        # (pids alone can collide host-to-host and tear the file)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix="layout_2d.npz.tmp.")
        with os.fdopen(fd, "wb") as f:  # file object: savez can't append ".npz"
            np.savez(f, loc=loc, source=np.asarray(source))
        # mkstemp creates mode 0600; the cache lives in a (possibly shared)
        # data dir and must stay readable by other users like a plain write
        os.chmod(tmp, 0o644)
        os.replace(tmp, final)
        tmp = None
        # Remove a shadowing legacy cache so future loads see the tagged one.
        try:
            os.remove(os.path.join(cache_dir, "layout_2d.npy"))
        except FileNotFoundError:
            pass
        return True
    except OSError:
        return False
    finally:
        if tmp is not None:  # failed write: don't leak the temp file
            try:
                os.remove(tmp)
            except OSError:
                pass


def _fallback_warning(dataset_name: str, cached: bool) -> None:
    via = "cached fallback layout" if cached else "geometric fallback"
    cprint(
        f"[layout] MNE unavailable — using {via} for {dataset_name}; positions "
        "are NOT exact. Regenerate with tools/precompute_layout.py (MNE env) "
        "for position-exact parity.",
        "yellow",
    )


def ch_locations_2d(
    dataset_name: str, root_dir: str = ".", cache: bool = True
) -> np.ndarray:
    """Return (C, 2) float32 sensor positions in [0.1, 0.9].

    An inexact (fallback-derived) layout is never served silently: a
    fallback/legacy cache triggers an MNE retry, and if MNE is still
    unavailable the cached fallback is returned with a warning on EVERY call.
    """
    if dataset_name not in NUM_CHANNELS:
        raise ValueError(f"Unknown dataset: {dataset_name}")

    cache_dir = os.path.join(root_dir, "data", dataset_name)
    cached_loc, cached_source = (None, None)
    if cache:
        cached_loc, cached_source = _load_cached(cache_dir, NUM_CHANNELS[dataset_name])
        if cached_loc is not None and cached_source == "mne":
            return cached_loc  # position-exact; trusted silently

    # No trusted cache: try MNE (also upgrades a stale fallback cache).
    loc = None
    try:
        loc = _try_mne(dataset_name, root_dir)
    except Exception as e:  # missing BIDS data etc.
        cprint(f"MNE layout failed ({e}); falling back", "yellow")
    if loc is not None:
        loc = _normalize(np.asarray(loc, np.float64))
        if cache:
            _write_cache(cache_dir, loc, "mne")
        return loc

    if cached_loc is not None:  # fallback/unknown provenance — warn every call
        _fallback_warning(dataset_name, cached=True)
        return cached_loc

    _fallback_warning(dataset_name, cached=False)
    loc = (
        _easycap_m10_fallback()
        if dataset_name == "Brennan2018"
        else _kit208_fallback()
    )
    loc = _normalize(np.asarray(loc, np.float64))
    if cache:
        _write_cache(cache_dir, loc, "fallback")
    return loc
