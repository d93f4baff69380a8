"""Synthetic dataset generation: tiny fake Brennan2018 (.mat + .wav) and
Gwilliams2022 (array-BIDS) trees, plus a tiny random frozen wav2vec2.

Port of ``speech_decoding_tpu/data/synthetic.py``. ``make_config``,
``make_brennan_tree`` and ``make_gwilliams_tree`` are copies: for the same
arguments they write the same files, byte for byte, as the JAX package's.
Used by the tests and ``examples/synthetic_demo.py``; the trees satisfy the
on-disk contracts the dataset pipelines expect
([ref: brennan2018.py:155,235; gwilliams2022.py:207-214,333-341] for the real
layouts; ArrayBIDSSource's layout for Gwilliams raw data).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple, Union

import numpy as np
import scipy.io
import scipy.io.wavfile
import torch

from speech_decoding_tpu_torch.config import Config, load_config


def make_config(root_dir: str, dataset: str = "Brennan2018", **over) -> Config:
    cfg = load_config()
    cfg.dataset = dataset
    cfg.root_dir = root_dir
    cfg.rebuild_dataset = False
    for k, v in over.items():
        cfg.set_path(k, v)
    return cfg


TINY_WAV2VEC = dict(
    conv_dim=(16, 16, 16),
    conv_stride=(10, 8, 4),
    conv_kernel=(10, 8, 4),
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=64,
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)


def tiny_wav2vec(device: Optional[Union[str, torch.device]] = None):
    """Tiny random wav2vec2 with the REAL total stride (320), so derived
    rates land near 120 Hz like the true model; the JAX fixture's config,
    weights drawn from seed 0, frozen on ``device`` (default ``cuda``;
    raises without a GPU unless ``device="cpu"``). The tests load the JAX
    fixture's weights into ``.model`` through
    ``models.params_bridge.load_flax_wav2vec2``."""
    from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2

    model = Wav2Vec2Model(Wav2Vec2Config(**TINY_WAV2VEC), generator=torch.Generator().manual_seed(0))
    return FrozenWav2Vec2(model, device)


def make_brennan_tree(
    root: str, n_subjects_present: int = 4, eeg_secs: float = 40.0, audio_secs: float = 40.0
) -> None:
    """Fake data/Brennan2018/{raw/*.mat, audio/*.wav}. Subject files S01.. are
    named to avoid the excluded-subject list."""
    raw_dir = os.path.join(root, "data", "Brennan2018", "raw")
    audio_dir = os.path.join(root, "data", "Brennan2018", "audio")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(audio_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    # two audio files at 44.1 kHz that concatenate to audio_secs
    sr = 44100
    t = np.arange(int(sr * audio_secs / 2)) / sr
    for i in range(2):
        wav = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t)
        )
        scipy.io.wavfile.write(
            os.path.join(audio_dir, f"audio{i + 1}.wav"),
            sr,
            (wav * 32767).astype(np.int16),
        )

    # EEG .mat files: raw struct with trial (60+4, T) @500 Hz and fsample
    fs = 500
    T = int(fs * eeg_secs)
    names = ["S01", "S03", "S04", "S05", "S06", "S08"][:n_subjects_present]
    for name in names:
        eeg = rng.normal(size=(64, T + rng.integers(0, 50))).astype(np.float64)
        raw = np.zeros((1, 1), dtype=[("trial", "O"), ("fsample", "O")])
        trial = np.zeros((1, 1), dtype=object)
        trial[0, 0] = eeg
        raw[0, 0]["trial"] = trial
        raw[0, 0]["fsample"] = np.array([[fs]])
        scipy.io.savemat(os.path.join(raw_dir, f"{name}.mat"), {"raw": raw})


def make_gwilliams_tree(
    root: str,
    n_subjects: int = 2,
    n_sessions: int = 2,
    n_tasks: int = 2,
    rec_secs: float = 30.0,
    n_words_per_task: int = 24,
    n_channels: int = 224,
    missing: Tuple[Tuple[int, ...], ...] = (),
) -> None:
    """Fake array-BIDS tree for Gwilliams2022: per-recording
    sub-XX/ses-S/meg/*.npy raw arrays + annotations.json, and task stimulus
    wavs under stimuli/audio (prefixes lw/cable/easy/the).

    ``missing``: (subject, session) entries drop a whole session;
    (subject, session, task) entries drop a single recording — the real
    MEG-MASC tree has such holes (the reference goes 167 -> 156 session-task
    keys [ref: gwilliams2022.py:458])."""
    base = os.path.join(root, "data", "Gwilliams2022")
    rng = np.random.default_rng(1)
    fs = 1000
    task_prefixes = ["lw", "cable", "easy", "the"]

    # stimuli: one wav per task
    stim_dir = os.path.join(base, "stimuli", "audio")
    os.makedirs(stim_dir, exist_ok=True)
    sr = 22050
    for task in range(n_tasks):
        t = np.arange(int(sr * rec_secs * 0.9)) / sr
        wav = 0.3 * np.sin(2 * np.pi * (200 + 60 * task) * t)
        scipy.io.wavfile.write(
            os.path.join(stim_dir, f"{task_prefixes[task]}_story.wav"),
            sr,
            (wav * 32767).astype(np.int16),
        )

    # word annotations: shared speech timeline per task
    word_gap = rec_secs * 0.8 / n_words_per_task
    for task in range(n_tasks):
        speech_onsets = 0.5 + np.arange(n_words_per_task) * word_gap
        sentence_idxs = (np.arange(n_words_per_task) // 4).astype(int)
        for subj in range(n_subjects):
            for sess in range(n_sessions):
                if (subj, sess) in missing or (subj, sess, task) in missing:
                    continue
                rec_dir = os.path.join(
                    base, f"sub-{subj + 1:02d}", f"ses-{sess}", "meg"
                )
                os.makedirs(rec_dir, exist_ok=True)
                T = int(fs * rec_secs) + int(rng.integers(0, 100))
                meg = rng.normal(size=(n_channels, T)).astype(np.float32)
                stem = f"sub-{subj + 1:02d}_ses-{sess}_task-{task}"
                np.save(os.path.join(rec_dir, f"{stem}_meg.npy"), meg)
                # MEG onsets: speech onsets plus a small per-recording delay
                meg_onsets = speech_onsets + 0.05 * (subj + 1)
                ann = {
                    "onset": meg_onsets.tolist(),
                    "description": [
                        {
                            "start": float(s),
                            "kind": "word",
                            "sequence_id": int(q),
                        }
                        for s, q in zip(speech_onsets, sentence_idxs)
                    ],
                }
                with open(os.path.join(rec_dir, f"{stem}_annotations.json"), "w") as f:
                    json.dump(ann, f)
