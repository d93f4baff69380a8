"""Gwilliams2022 (MEG-MASC) dataset pipeline.

Port of ``speech_decoding_tpu/data/gwilliams2022.py``, which re-implements
the reference Gwilliams2022 dataset family
[ref: speech_decoding/dataclass/gwilliams2022.py:42-720]:

  * raw ingest is a pluggable ``RawSource`` (host I/O only): ``MNEBIDSSource``
    uses mne_bids like the reference when MNE is installed
    [ref: gwilliams2022.py:207-251]; ``ArrayBIDSSource`` reads a documented
    array layout (sub-XX/ses-S/meg/*_meg.npy + *_annotations.json) so the
    pipeline runs hermetically (tests, MNE-less environments);
  * MEG preprocessing (band-pass 1–60 Hz @ 1 kHz, resample to 120 Hz
    [ref: gwilliams2022.py:253-260]) is the port's batched
    ``ops.brain_preproc.preprocess_batch`` (or ``preprocess_auto``) on the
    dataset's device;
  * the stimulus audio goes through the port's ``sinc_resample``, wav2vec2
    (``embed_waveform``) and ``fft_resample`` on the same device;
  * word-onset parsing (kind=='word' filter, per-file onset stitching,
    sentence ids) is pure host logic [ref: gwilliams2022.py:664-720], with the
    reference's cross-subject speech-onset consistency asserts
    [ref: gwilliams2022.py:239-243];
  * caching follows the settings.json / x_done / y_done contract
    [ref: gwilliams2022.py:62-109] via data/preproc_cache.py, in the JAX
    package's on-disk format (the ``npy`` dicts, the ``_parts`` directory
    under ``memory_efficient``, the settings JSON): a cache built by either
    package loads in the other;
  * three split modes (sentence / shallow / deep) operate on the segment
    manifest [ref: gwilliams2022.py:390-637]; X stays whole per recording and
    segments are lazy onset slices [ref: gwilliams2022.py:137-138], gathered
    by the native ``data.native_loader.gather_segments``;
  * the per-batch baseline/scale/clamp collator
    [ref: gwilliams2022.py:640-661] runs inside the train step
    (ops/scaling.apply_scale_stats on per-word stats computed here once).

The datasets build on ``device`` (default ``cuda``; raises without a GPU
unless ``device="cpu"``). The same ``rng`` draws the same batches as in the
JAX package.
"""

from __future__ import annotations

import ast
import json
import os
from glob import glob
from typing import Dict, List, Sequence, Tuple

import numpy as np

import torch

from speech_decoding_tpu_torch.data.native_loader import gather_segments
from speech_decoding_tpu_torch.data.preproc_cache import check_preprocs, mark_done
from speech_decoding_tpu_torch.ops.brain_preproc import preprocess_batch
from speech_decoding_tpu_torch.ops.preproc_dispatch import derive_transfer_dtype, preprocess_auto
from speech_decoding_tpu_torch.ops.resample import fft_resample, sinc_resample
from speech_decoding_tpu_torch.ops.scaling import window_scale_stats
from speech_decoding_tpu_torch.utils.device import resolve_device
from speech_decoding_tpu_torch.utils.logging import cprint
from speech_decoding_tpu_torch.utils.natsort import natsorted
from speech_decoding_tpu_torch.utils.wavio import load_wav

TASK_PREFIXES = ["lw", "cable", "easy", "the"]  # [ref: gwilliams2022.py:69]
NUM_MEG_CHANNELS = 208  # of 224; last 16 are reference sensors
BRAIN_ORIG_RATE = 1000.0


# ---------------------------------------------------------------------------
# Onset parsing (pure host logic)
# ---------------------------------------------------------------------------


def continuous(onsets: np.ndarray) -> np.ndarray:
    """Stitch per-audio-file onsets (each restarting at ~0) into one
    monotonically increasing timeline [ref: gwilliams2022.py:668-687]."""
    onsets = np.array(onsets, dtype=np.float64)
    base = 0.0
    for i in range(len(onsets)):
        update = i < len(onsets) - 1 and onsets[i + 1] < onsets[i]
        if update:
            next_base = base + onsets[i]
        onsets[i] += base
        if update:
            base = next_base
    return onsets


def drop_overlapping_words(
    word_onset_idxs, word_onsets, sentence_idxs, min_gap_sec=None
):
    """Drop word onsets whose segment would straddle the NEXT sentence's
    onset: "word onsets that have less than 3 seconds until next sentence
    onset should be dropped so that they don't go across splits" — the
    reference documents this but leaves it unimplemented (TODO stub,
    [ref: gwilliams2022.py:690-697]).

    ``min_gap_sec=None`` (default) reproduces the stub exactly (no-op, the
    parity behavior); setting it (``preprocs.drop_overlap_sec``, typically
    seq_len_sec=3.0) enables the documented semantics: a word is kept iff it
    is in the LAST sentence, or the first word of the following sentence
    starts at least ``min_gap_sec`` later."""
    if min_gap_sec is None or len(word_onsets) == 0:
        return word_onset_idxs, word_onsets, sentence_idxs
    word_onset_idxs = np.asarray(word_onset_idxs)
    word_onsets = np.asarray(word_onsets)
    sentence_idxs = np.asarray(sentence_idxs)
    # onset of the next DIFFERENT sentence for every word (inf for the last
    # sentence), computed right-to-left
    n = len(word_onsets)
    next_sent_onset = np.full(n, np.inf)
    nxt = np.inf
    for i in range(n - 1, 0, -1):
        if sentence_idxs[i] != sentence_idxs[i - 1]:
            nxt = word_onsets[i]
        next_sent_onset[i - 1] = nxt
    keep = (next_sent_onset - word_onsets) >= min_gap_sec
    return word_onset_idxs[keep], word_onsets[keep], sentence_idxs[keep]


def parse_annotations(
    descriptions: Sequence, drop_overlap_sec=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """From per-annotation description dicts (or their str repr), extract
    word-onset indices, stitched speech onsets and sentence ids
    [ref: gwilliams2022.py:700-720]."""
    rows = [
        ast.literal_eval(d) if isinstance(d, str) else dict(d) for d in descriptions
    ]
    starts = continuous(np.array([r["start"] for r in rows], np.float64))
    kinds = np.array([r["kind"] for r in rows])
    word_onset_idxs = np.where(kinds == "word")[0]
    word_onsets = starts[word_onset_idxs]
    sentence_idxs = np.array([rows[i]["sequence_id"] for i in word_onset_idxs])
    return drop_overlapping_words(
        word_onset_idxs, word_onsets, sentence_idxs, drop_overlap_sec
    )


# ---------------------------------------------------------------------------
# Raw sources (host-side I/O only)
# ---------------------------------------------------------------------------


class ArrayBIDSSource:
    """Array-layout source: ``{root}/sub-XX/ses-S/meg/sub-XX_ses-S_task-T_meg.npy``
    (n_channels, T) float raw MEG plus ``…_annotations.json`` with keys
    ``onset`` (list of seconds) and ``description`` (list of dicts with
    start/kind/sequence_id)."""

    def __init__(self, root_dir: str, drop_overlap_sec=None):
        self.root = root_dir
        self.drop_overlap_sec = drop_overlap_sec

    def read(self, subject: int, session: int, task: int):
        stem = f"sub-{subject + 1:02d}_ses-{session}_task-{task}"
        rec_dir = os.path.join(self.root, f"sub-{subject + 1:02d}", f"ses-{session}", "meg")
        meg_path = os.path.join(rec_dir, f"{stem}_meg.npy")
        ann_path = os.path.join(rec_dir, f"{stem}_annotations.json")
        if not (os.path.exists(meg_path) and os.path.exists(ann_path)):
            return None
        meg = np.load(meg_path)
        with open(ann_path) as f:
            ann = json.load(f)
        word_idxs, speech_onsets, sentence_idxs = parse_annotations(
            ann["description"], self.drop_overlap_sec
        )
        meg_onsets = np.asarray(ann["onset"], np.float64)[word_idxs]
        return meg, meg_onsets, speech_onsets, sentence_idxs


class MNEBIDSSource:
    """The reference's exact ingest path, used when mne_bids is installed
    [ref: gwilliams2022.py:207-251]. Timestamps convert via
    minute*60 + second + microsecond*1e-6 [ref: gwilliams2022.py:664-665]."""

    def __init__(self, root_dir: str, drop_overlap_sec=None):
        self.root = root_dir
        self.drop_overlap_sec = drop_overlap_sec

    def read(self, subject: int, session: int, task: int):
        import mne
        import mne_bids

        mne.set_log_level(verbose="WARNING")
        bids_path = mne_bids.BIDSPath(
            subject=str(subject + 1).zfill(2),
            session=str(session),
            task=str(task),
            datatype="meg",
            root=self.root,
        )
        try:
            raw = mne_bids.read_raw_bids(bids_path)
        except Exception:
            cprint("No .con data was found", "yellow")
            return None
        df = raw.to_data_frame()
        df_annot = raw.annotations.to_data_frame()
        word_idxs, speech_onsets, sentence_idxs = parse_annotations(
            df_annot.description.to_list(), self.drop_overlap_sec
        )
        meg_onsets = np.array(
            [o.minute * 60 + o.second + o.microsecond * 1e-6 for o in df_annot.onset]
        )[word_idxs]
        meg = np.stack([df[k] for k in df.keys() if "MEG" in k])
        return meg, meg_onsets, speech_onsets, sentence_idxs


def default_source(root_dir: str, drop_overlap_sec=None):
    try:
        import mne_bids

        # importable is not enough: verify the API surface actually exists
        # (guards against stub/broken installs and test fakes)
        if hasattr(mne_bids, "BIDSPath") and hasattr(mne_bids, "read_raw_bids"):
            return MNEBIDSSource(root_dir, drop_overlap_sec)
    except ImportError:
        pass
    return ArrayBIDSSource(root_dir, drop_overlap_sec)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class Gwilliams2022DatasetBase:
    """Build-or-load X/Y caches, then ``batchfy()`` (split-mode hook).

    After construction:
      X: {key_no_task: {taskN: (208, T) float32 raw (unscaled) MEG}}
      Y: (num_segments, F, seq_len) float32 audio embeddings
      meg_onsets: {key_no_task: {taskN: (n_words,) sample indices}}
    """

    def __init__(self, args, wav2vec=None, source=None, num_subjects: int = 27,
                 num_sessions: int = 2, num_tasks: int = 4, device=None):
        self.device = resolve_device(device)
        self.root_dir = os.path.join(args.root_dir, "data", "Gwilliams2022")
        self.wav2vec_model = args.wav2vec_model
        self.preprocs = dict(args.preprocs)
        self.brain_resample_rate = args.preprocs["brain_resample_rate"]
        self.brain_filter_low = args.preprocs["brain_filter_low"]
        self.brain_filter_high = args.preprocs["brain_filter_high"]
        self.seq_len_samp = int(self.brain_resample_rate * args.preprocs["seq_len_sec"])
        self.audio_resample_rate = args.preprocs["audio_resample_rate"]
        self.lowpass_filter_width = args.preprocs["lowpass_filter_width"]
        self.last4layers = args.preprocs["last4layers"]
        self.shift_brain = args.preprocs["shift_brain"]
        self.shift_len = args.preprocs["shift_len"]
        # memory_efficient (the reference declares this config key but never
        # uses it [ref: configs/config.yaml:48]; its multiprocessing pipeline
        # had a known "huge memory consumption" issue [ref: README.md:15]):
        # keep preprocessed recordings as memory-mapped per-recording .npy
        # parts instead of one in-RAM dict, and fold the brain shift into the
        # onset indices so no sliced copies are ever materialized.
        self.memory_efficient = bool(args.get("memory_efficient", True))
        # tpu.preproc_backend: device | host | auto (see configs/config.yaml)
        self.preproc_backend = str(args.select("tpu.preproc_backend", "device") or "device")
        # raw-upload dtype for device-routed preprocessing (None = derive:
        # int16 on the auto/host route unless exact_mne_grid, see below)
        self.preproc_transfer_dtype = args.select("tpu.preproc_transfer_dtype", None)
        self._wav2vec = wav2vec
        # preprocs.drop_overlap_sec enables the reference's DOCUMENTED-but-
        # unimplemented drop_overlapping_words (typically = seq_len_sec);
        # absent/None keeps stub parity. Lives under preprocs so it is part
        # of the cache key.
        self._source = source or default_source(
            self.root_dir, self.preprocs.get("drop_overlap_sec")
        )
        self._dims = (num_subjects, num_sessions, num_tasks)

        rebuild = bool(args.get("rebuild_dataset", False))
        flags, self.preproc_dir = check_preprocs(
            self.preprocs, os.path.join(self.root_dir, "preprocessed") + os.sep
        )

        x_path = os.path.join(self.preproc_dir, "x_dict.npy")
        self._parts_dir = os.path.join(self.preproc_dir, "_parts")
        onsets_path = os.path.join(self.preproc_dir, "meg_onsets.npy")
        speech_path = os.path.join(self.preproc_dir, "speech_onsets.npy")
        sent_path = os.path.join(self.preproc_dir, "sentence_idxs.npy")
        if rebuild or not flags["x_done"]:
            X, meg_onsets, speech_onsets, sentence_idxs = self.brain_preproc_all()
            if not self.memory_efficient:
                np.save(x_path, X, allow_pickle=True)
            np.save(onsets_path, meg_onsets, allow_pickle=True)
            np.save(speech_path, speech_onsets, allow_pickle=True)
            np.save(sent_path, sentence_idxs, allow_pickle=True)
            mark_done(self.preprocs, self.preproc_dir, "x_done")
            self.X, self.meg_onsets = X, meg_onsets
            self.speech_onsets, self.sentence_idxs = speech_onsets, sentence_idxs
        else:
            self.X = self._load_x(x_path)
            self.meg_onsets = np.load(onsets_path, allow_pickle=True).item()
            self.speech_onsets = np.load(speech_path, allow_pickle=True).item()
            self.sentence_idxs = np.load(sent_path, allow_pickle=True).item()

        y_path = os.path.join(self.preproc_dir, "y_dict.npy")
        if rebuild or not flags["y_done"]:
            Y = self.audio_preproc()
            np.save(y_path, Y, allow_pickle=True)
            mark_done(self.preprocs, self.preproc_dir, "y_done")
            self.Y = Y
        else:
            self.Y = np.load(y_path, allow_pickle=True).item()

        self.X, self.Y, self.meg_onsets, self.num_segments_foreach_task = self.batchfy()
        assert len(self.X) == len(self.meg_onsets)
        # per-(session, task, word) robust-scaling stats, computed once so the
        # train-step collate is pure elementwise (the reference re-fits a
        # RobustScaler per batch on CPU [ref: gwilliams2022.py:653-661]; the
        # baseline subtraction cancels inside the median, see
        # ops.scaling.gwilliams_collate)
        self.scale_stats = self._compute_scale_stats()
        self.valid_subjects = np.array(
            sorted(set(k.split("_")[0] for k in self.X.keys()))
        )
        self.num_subjects = len(self.valid_subjects)
        cprint(
            f"Gwilliams2022: {len(self.X)} sessions, {len(self.Y)} segments, "
            f"{self.num_subjects} subjects",
            "cyan",
        )

    # -- preprocessing ------------------------------------------------------

    def brain_preproc_all(self):
        """Read every available recording (host I/O), then run the fused
        batched device filter+resample. Deterministic key order replaces the
        reference's worker-pool + natsorted temp-file reassembly
        [ref: gwilliams2022.py:267-325]. Each processed recording is cached as
        a per-recording part file, so an interrupted rebuild resumes at
        recording granularity (finer than the reference's all-or-nothing
        x_done flag)."""
        parts_dir = os.path.join(self.preproc_dir, "_parts")
        os.makedirs(parts_dir, exist_ok=True)

        n_subj, n_sess, n_task = self._dims
        raw_list, todo_keys, keys = [], [], []
        meg_onsets: Dict[str, np.ndarray] = {}
        speech_onsets: Dict[str, np.ndarray] = {}
        sentence_idxs: Dict[str, np.ndarray] = {}
        for subject in range(n_subj):
            for session in range(n_sess):
                for task in range(n_task):
                    out = self._source.read(subject, session, task)
                    if out is None:
                        continue  # tolerate missing recordings
                    meg, m_on, s_on, s_idx = out
                    key = f"subject{subject + 1:02d}_sess{session}_task{task}"
                    task_str = f"task{task}"
                    if task_str in speech_onsets:
                        # cross-subject consistency contract
                        # [ref: gwilliams2022.py:239-243]
                        assert np.allclose(
                            speech_onsets[task_str], s_on
                        ), "Speech onsets are different"
                        assert np.array_equal(sentence_idxs[task_str], s_idx)
                    speech_onsets[task_str] = s_on
                    sentence_idxs[task_str] = s_idx
                    meg_onsets[key] = m_on
                    keys.append(key)
                    if not os.path.exists(os.path.join(parts_dir, f"{key}.npy")):
                        raw_list.append(np.asarray(meg[:NUM_MEG_CHANNELS], np.float32))
                        todo_keys.append(key)
        assert keys, f"no recordings found under {self.root_dir}"
        if todo_keys:
            cprint(
                f"Batched device preprocessing of {len(todo_keys)} recordings "
                f"({len(keys) - len(todo_keys)} resumed from parts)",
                "cyan",
            )
            exact_grid = bool(self.preprocs.get("exact_mne_grid", False))
            # the shared upload-dtype rule (ops/preproc_dispatch.py):
            # explicit tpu.preproc_transfer_dtype wins; device backend ships
            # float32 (parity-first); auto/host routes ship int16 unless
            # exact_mne_grid's byte-stability promise demands float32
            transfer = derive_transfer_dtype(
                self.preproc_transfer_dtype, exact_grid, self.preproc_backend
            )
            if self.preproc_backend in ("host", "auto"):
                # hybrid/host routing (every route runs the exact MNE grid;
                # see ops/preproc_dispatch.py)
                outs = preprocess_auto(
                    raw_list,
                    BRAIN_ORIG_RATE,
                    self.brain_filter_low,
                    self.brain_filter_high,
                    float(self.brain_resample_rate),
                    transfer_dtype=transfer,
                    force=None if self.preproc_backend == "auto" else "host",
                    device=self.device,
                )
            else:
                outs = preprocess_batch(
                    raw_list,
                    BRAIN_ORIG_RATE,
                    self.brain_filter_low,
                    self.brain_filter_high,
                    float(self.brain_resample_rate),
                    # preprocs.exact_mne_grid=true: byte-parity with MNE's
                    # per-recording resample grid (full-pipeline golden
                    # tests/test_pipeline_golden_gwilliams.py) at ~2x FFT cost;
                    # default = fused exact-rational grid (sub-sample deviation,
                    # documented in PARITY.md)
                    exact_grid=exact_grid,
                    transfer_dtype=transfer,
                    device=self.device,
                )
            for k, o in zip(todo_keys, outs):
                np.save(os.path.join(parts_dir, f"{k}.npy"), o.astype(np.float32))
        if self.memory_efficient:
            # parts stay on disk, memory-mapped (the OS page cache serves the
            # native gather); no monolithic in-RAM dict is ever built
            X = {
                k: np.load(os.path.join(parts_dir, f"{k}.npy"), mmap_mode="r")
                for k in keys
            }
        else:
            X = {k: np.load(os.path.join(parts_dir, f"{k}.npy")) for k in keys}
            import shutil

            shutil.rmtree(parts_dir)  # assembled into x_dict.npy by the caller
        return X, meg_onsets, speech_onsets, sentence_idxs

    def _load_x(self, x_path: str) -> Dict[str, np.ndarray]:
        """Load the preprocessed X cache: memory-mapped parts when
        memory_efficient (falling back to the dict file), else the dict."""
        if os.path.isdir(self._parts_dir) and (
            self.memory_efficient or not os.path.exists(x_path)
        ):
            mode = "r" if self.memory_efficient else None
            keys = [
                os.path.splitext(f)[0]
                for f in natsorted(os.listdir(self._parts_dir))
                if f.endswith(".npy")
            ]
            return {
                k: np.load(os.path.join(self._parts_dir, f"{k}.npy"), mmap_mode=mode)
                for k in keys
            }
        return np.load(x_path, allow_pickle=True).item()

    def audio_preproc(self) -> Dict[str, np.ndarray]:
        """Per task: stimulus wavs -> 16 kHz -> wav2vec embeddings -> 120 Hz
        [ref: gwilliams2022.py:327-387]."""
        from speech_decoding_tpu_torch.models.wav2vec_util import (
            embed_waveform,
            load_wav2vec_model,
        )

        if self._wav2vec is None:  # lazy: only needed on rebuild
            self._wav2vec = load_wav2vec_model(self.wav2vec_model, device=self.device)

        stim_dir = os.path.join(self.root_dir, "stimuli", "audio")
        assert os.path.exists(stim_dir), f"missing {stim_dir}"
        Y: Dict[str, np.ndarray] = {}
        for task_str in sorted(self.speech_onsets.keys()):
            task_id = int(task_str[-1])
            paths = natsorted(
                glob(os.path.join(stim_dir, f"{TASK_PREFIXES[task_id]}*.wav"))
            )
            chunks = []
            for path in paths:
                wave, sr = load_wav(path)
                wave16 = sinc_resample(
                    torch.from_numpy(wave[:1]).to(self.device), sr, self.audio_resample_rate,
                    lowpass_filter_width=self.lowpass_filter_width,
                ).cpu().numpy()
                emb = embed_waveform(self._wav2vec, wave16[0], self.last4layers)
                rate_after = self.audio_resample_rate * emb.shape[-1] / wave16.shape[-1]
                emb = fft_resample(
                    torch.from_numpy(emb).to(self.device),
                    up=self.brain_resample_rate / rate_after,
                ).cpu().numpy()
                chunks.append(emb)
            Y[task_str] = np.concatenate(chunks, axis=-1).astype(np.float32)
        return Y

    # -- shared batchfy machinery -------------------------------------------

    def _shift(self, data: np.ndarray, is_Y: bool) -> np.ndarray:
        """150 ms brain shift [ref: gwilliams2022.py:170-180]."""
        shift = int(self.brain_resample_rate * (self.shift_len / 1000))
        return data[:, :-shift] if is_Y else data[:, shift:]

    def segment_speech(self, Y: np.ndarray, task_str: str) -> np.ndarray:
        onsets = (
            (self.speech_onsets[task_str] * self.brain_resample_rate).round().astype(int)
        )
        segs = [Y[:, o : o + self.seq_len_samp] for o in onsets]
        return np.stack(segs)

    def sentence_to_word_idxs(self, wanted_sentences, task_str: str) -> List[int]:
        sidx = self.sentence_idxs[task_str]
        wanted = set(np.asarray(wanted_sentences).tolist())
        return [i for i, s in enumerate(sidx) if s in wanted]

    def drop_task_missing_sessions(self) -> None:
        """Drop sessions lacking the full task set [ref: gwilliams2022.py:182-190]."""
        n_tasks = self._dims[2]
        sess_strs = set("_".join(k.split("_")[:-1]) for k in self.X.keys())
        for sess in sess_strs:
            keys = [k for k in self.X.keys() if k.startswith(sess + "_")]
            if len(keys) < n_tasks:
                for k in keys:
                    self.X.pop(k)
                    self.meg_onsets.pop(k)

    def _make_Y(self, word_filter) -> Tuple[np.ndarray, List[int]]:
        """Segment Y per task at word onsets, optionally filtered by
        word_filter(task_str) -> indices (None = keep all). Also records the
        (task id, onset sample) of every kept segment — the device-resident
        data path gathers Y windows from unsegmented task arrays with these."""
        Y_list = []
        seg_tasks, seg_onsets = [], []
        for task_str in sorted(self.Y.keys(), key=lambda s: int(s[-1])):
            Y = self.Y[task_str]
            if self.shift_brain:
                Y = self._shift(Y, is_Y=True)
            segs = self.segment_speech(Y, task_str)
            onsets = (
                (self.speech_onsets[task_str] * self.brain_resample_rate)
                .round()
                .astype(int)
            )
            idxs = word_filter(task_str) if word_filter else None
            if idxs is not None:
                segs = segs[idxs]
                onsets = onsets[idxs]
            Y_list.append(segs.astype(np.float32))
            seg_tasks.append(np.full(len(onsets), int(task_str[-1]), np.int32))
            seg_onsets.append(np.asarray(onsets, np.int32))
        counts = [len(y) for y in Y_list]
        self.segment_task_ids = np.concatenate(seg_tasks)
        self.segment_y_onsets = np.concatenate(seg_onsets)
        return np.concatenate(Y_list), counts

    def _make_X(self, onset_filter):
        """Group X/onsets by session key; onsets to sample indices, optionally
        filtered per task by onset_filter(task_str) -> indices."""
        self.drop_task_missing_sessions()
        assert len(self.X) % self._dims[2] == 0
        X_dict: Dict[str, Dict[str, np.ndarray]] = {}
        onsets_dict: Dict[str, Dict[str, np.ndarray]] = {}
        shift = int(self.brain_resample_rate * (self.shift_len / 1000))
        for key in natsorted(self.X.keys()):
            X = self.X[key]
            task_str = key.split("_")[-1]
            key_no_task = "_".join(key.split("_")[:-1])
            onsets = (
                (self.meg_onsets[key] * self.brain_resample_rate).round().astype(int)
            )
            if self.shift_brain:
                if self.memory_efficient:
                    # fold the shift into the onsets: X[shift:][o:o+L] ==
                    # X[o+shift : o+shift+L]; keeps X memory-mapped/unsliced
                    onsets = onsets + shift
                else:
                    X = self._shift(X, is_Y=False)
            idxs = onset_filter(task_str) if onset_filter else None
            if idxs is not None:
                onsets = onsets[idxs]
            if not (X.dtype == np.float32 and isinstance(X, np.memmap)):
                X = np.ascontiguousarray(X, np.float32)
            X_dict.setdefault(key_no_task, {})[task_str] = X
            onsets_dict.setdefault(key_no_task, {})[task_str] = onsets
        return X_dict, onsets_dict

    def batchfy(self):  # overridden by split subclasses
        raise NotImplementedError

    def _compute_scale_stats(self, chunk: int = 1024) -> Dict[str, Dict[str, np.ndarray]]:
        """One batched device pass per (session, task): median/IQR of every
        word window -> {key: {task: (n_words, C, 2) float32}}."""
        stats: Dict[str, Dict[str, np.ndarray]] = {}
        L = self.seq_len_samp
        for key, tasks in self.X.items():
            stats[key] = {}
            for task, X in tasks.items():
                onsets = self.meg_onsets[key][task]
                outs = []
                for i in range(0, len(onsets), chunk):
                    ons = onsets[i : i + chunk]
                    windows = gather_segments([X] * len(ons), ons, L)
                    outs.append(window_scale_stats(torch.from_numpy(windows).to(self.device)).cpu().numpy())
                stats[key][task] = (
                    np.concatenate(outs) if outs else np.zeros((0, X.shape[0], 2), np.float32)
                )
        return stats

    # -- segment access ------------------------------------------------------

    def __len__(self) -> int:
        return len(self.Y)

    def segment_to_task(self, i: int) -> Tuple[int, str]:
        accum = np.cumsum(self.num_segments_foreach_task)
        task = int(np.searchsorted(accum, i + 1))
        i_in_task = int(i - (accum[task - 1] if task else 0))
        return i_in_task, f"task{task}"

    def draw_choices(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """The random-session draws of ``sample_batch`` (one scalar draw per
        segment, exactly the internal pattern so the rng stream position
        matches), exposed for multi-host global sampling: every host draws
        the full global batch's choices from the shared rng, then
        materializes only its block."""
        n_keys = len(self.X)
        return np.asarray([rng.integers(n_keys) for _ in range(n)])

    def sample_batch(
        self,
        rng: np.random.Generator,
        segment_ids: np.ndarray,
        choices: np.ndarray = None,
    ):
        """Assemble a batch: per segment a RANDOM session key
        [ref: gwilliams2022.py:129-142]; X is the raw onset slice (scaling
        happens in the train step's collate). ``choices`` overrides the
        internal per-segment draw (multi-host global sampling)."""
        keys = list(self.X.keys())
        L = self.seq_len_samp
        if choices is None:
            choices = self.draw_choices(rng, len(segment_ids))
        sources, onsets, sids, stats = [], [], [], []
        for i, choice in zip(segment_ids, choices):
            i_in_task, task = self.segment_to_task(int(i))
            key = keys[int(choice)]
            sources.append(self.X[key][task])
            onsets.append(int(self.meg_onsets[key][task][i_in_task]))
            stats.append(self.scale_stats[key][task][i_in_task])
            sids.append(
                int(np.where(self.valid_subjects == key.split("_")[0])[0][0])
            )
        return {
            "X": gather_segments(sources, onsets, seq_len=L),
            "Y": self.Y[segment_ids],
            "subject_idxs": np.asarray(sids, np.int32),
            "scale_stats": np.stack(stats),
        }


class Gwilliams2022ShallowSplit(Gwilliams2022DatasetBase):
    """Keep all segments; the random 80/20 split happens downstream
    [ref: gwilliams2022.py:494-557, train.py:74-78]."""

    def batchfy(self):
        Y, counts = self._make_Y(None)
        X, onsets = self._make_X(None)
        return X, Y, onsets, counts


class Gwilliams2022SentenceSplit(Gwilliams2022DatasetBase):
    """Split at sentence granularity: shuffle unique sentence ids per task,
    split by ratio, map back to word indices; a train instance computes and
    exposes test_word_idxs_dict for the test instance
    [ref: gwilliams2022.py:390-491, train.py:58-59]."""

    def __init__(self, args, test_word_idxs_dict=None, **kw):
        self.train = test_word_idxs_dict is None
        self.test_word_idxs_dict = test_word_idxs_dict
        self.split_ratio = args.split_ratio
        # RNG contract (VERDICT r3 item 6): the reference shuffles sentences
        # with the GLOBAL numpy RNG [ref: gwilliams2022.py:424-441], so split
        # membership depends on everything seeded/consumed before it (module
        # import order, any earlier np.random call). Default: an explicit
        # Generator keyed only on the run's resolved seed — the split is a
        # pure function of the seed, reconstructable by resume/evaluate no
        # matter what else ran first. split_legacy_global_rng=true replicates
        # the reference behavior (executed-reference golden uses it).
        self.split_legacy_global_rng = bool(args.get("split_legacy_global_rng", False))
        _rs = args.select("resolved_seed", None)  # 0 is a valid drawn seed
        self._split_seed = int(_rs if _rs is not None else args.get("seed", 0))
        super().__init__(args, **kw)

    def batchfy(self):
        if self.train:
            if self.split_legacy_global_rng:
                shuffle = np.random.shuffle
            else:
                # (seed, constant) entropy pair: independent of the other
                # seed-derived streams (epoch rng, test-batch rng, ...)
                shuffle = np.random.default_rng((self._split_seed, 20221102)).shuffle
            train_idxs: Dict[str, List[int]] = {}
            test_idxs: Dict[str, List[int]] = {}
            for task_str in sorted(self.Y.keys(), key=lambda s: int(s[-1])):
                sentences = np.unique(self.sentence_idxs[task_str])
                shuffle(sentences)
                split = int(len(sentences) * self.split_ratio)
                train_idxs[task_str] = self.sentence_to_word_idxs(
                    sentences[:split], task_str
                )
                test_idxs[task_str] = self.sentence_to_word_idxs(
                    sentences[split:], task_str
                )
            self.test_word_idxs_dict = test_idxs
            word_filter = lambda t: train_idxs[t]
        else:
            word_filter = lambda t: self.test_word_idxs_dict[t]
        Y, counts = self._make_Y(word_filter)
        X, onsets = self._make_X(word_filter)
        return X, Y, onsets, counts


class Gwilliams2022DeepSplit(Gwilliams2022DatasetBase):
    """Temporal split: first ratio of each task's segments = train
    [ref: gwilliams2022.py:560-637]."""

    def __init__(self, args, train: bool, **kw):
        self.train = train
        self.split_ratio = args.split_ratio
        super().__init__(args, **kw)

    def batchfy(self):
        def word_filter(task_str):
            n = len(self.speech_onsets[task_str])
            split = int(n * self.split_ratio)
            return list(range(split)) if self.train else list(range(split, n))

        Y, counts = self._make_Y(word_filter)
        X, onsets = self._make_X(word_filter)
        return X, Y, onsets, counts
