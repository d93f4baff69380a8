"""Inputs made from ``--seed``: the encoder's weights and the training
world, at a configuration's shapes.

Everything is drawn on the run's device in a few large calls. The program
is handed these tensors; the reference is handed the same and gathers its
own batches from them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from port_bench.reference import param_shapes


def sub_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for the draw named ``tag`` of run ``seed``."""
    return int(np.random.SeedSequence([int(seed), *tag]).generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed: int, tag: Tuple[int, ...], device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tag))


def _init_bound(name: str, shape: Tuple[int, ...], cfg: Dict) -> Tuple[float, float]:
    """torch-default bounds: U(±1/sqrt(fan_in)) for conv kernels and their
    biases, U(±1/sqrt(D1)) for the subject kernels, U(0, 1) for z."""
    if name.endswith("z_re") or name.endswith("z_im"):
        return 0.0, 1.0
    if name.endswith("subject_kernel"):
        b = 1.0 / math.sqrt(cfg["D1"])
        return -b, b
    base = name.rsplit(".", 1)[0]
    shapes = param_shapes(cfg)
    k, cin, _ = shapes[f"{base}.kernel"]
    b = 1.0 / math.sqrt(cin * k)
    return -b, b


def make_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and BatchNorm statistic of an encoder about to train,
    float32 on ``device``, by name: weights uniform at torch's default
    bounds from one draw, BatchNorm at its initial 1, 0, 0, 1."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator(seed, (1,), device), device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = u[off : off + n].view(shape)
        off += n
        if ".batchnorm" in name:
            leaf = name.rsplit(".", 1)[1]
            out[name] = torch.full(shape, 1.0 if leaf in ("scale", "var") else 0.0, device=device)
        else:
            lo, hi = _init_bound(name, shape, cfg)
            out[name] = lo + (hi - lo) * x
    return out


# -- Gwilliams2022: the device-resident world ---------------------------------------

class GwilliamsWorld:
    """MEG-MASC at its shapes on the device, as the device-resident batcher
    stores it (float32, time-major): X (R, T_max + L, C) over R = subjects ×
    sessions × tasks recordings, zero past each task's end; Y (tasks, T_max +
    L, F) unsegmented task embeddings; per-word [median, IQR] statistics (R,
    W_max, C, 2); word onsets (R, W_max). One segment a word; a segment's X
    window starts at its word onset plus the 150 ms shift, its Y window at
    the onset."""

    def __init__(self, cfg: Dict, seed: int, device):
        C, F, L, rate = cfg["C"], cfg["F"], cfg["T"], cfg["brain_rate_hz"]
        S, E, n_tasks = cfg["S"], cfg["sessions"], cfg["tasks"]
        shift = int(rate * cfg["shift_ms"] / 1000)
        self.task_len = [int(s * rate) for s in cfg["task_seconds"]]
        T_max = max(self.task_len)
        self.L, self.shift = L, shift
        rng = np.random.default_rng(sub_seed(seed, 2))
        # word onsets (samples) of each task: spread over the story, sorted
        self.word_onsets = []
        for n in self.task_len:
            words = int(n / rate * cfg["words_per_second"])
            self.word_onsets.append(np.sort(rng.integers(0, n - L - shift, size=words)).astype(np.int64))
        self.words = [len(w) for w in self.word_onsets]
        W_max = max(self.words)
        self.session_keys = [f"sub-{s + 1:02d}_ses-{e}" for s in range(S) for e in range(E)]
        self.rec_index = {}
        subject_of_rec, task_of_rec = [], []
        for ki, key in enumerate(self.session_keys):
            for t in range(n_tasks):
                self.rec_index[(key, f"task{t}")] = len(subject_of_rec)
                subject_of_rec.append(ki // E)
                task_of_rec.append(t)
        self.subject_of_rec = np.asarray(subject_of_rec, np.int32)
        R = len(subject_of_rec)
        g = generator(seed, (3,), device)
        self.X_stack = torch.empty((R, T_max + L, C), device=device).normal_(generator=g)
        task_of = torch.as_tensor(task_of_rec, device=device)
        for t, n in enumerate(self.task_len):
            self.X_stack[(task_of == t).nonzero()[:, 0], n:] = 0.0
        self.Y_stack = torch.empty((n_tasks, T_max + L, F), device=device).normal_(generator=g)
        for t, n in enumerate(self.task_len):
            self.Y_stack[t, n:] = 0.0
        self.stats_stack = torch.empty((R, W_max, C, 2), device=device)
        self.stats_stack[..., 0].normal_(0.0, 0.05, generator=g)
        self.stats_stack[..., 1].uniform_(1.2, 1.5, generator=g)
        onsets = np.zeros((R, W_max), np.int64)
        for r, t in enumerate(task_of_rec):
            onsets[r, : self.words[t]] = self.word_onsets[t] + shift
        self.onsets_stack = torch.from_numpy(onsets).to(device)
        self.seg_task_ids = np.concatenate([np.full(w, t, np.int32) for t, w in enumerate(self.words)])
        self.seg_y_onsets = np.concatenate(self.word_onsets).astype(np.int32)
        self.n_segments = len(self.seg_task_ids)

    def segment(self, i: int) -> Tuple[int, int]:
        """(task, word index within the task) of segment ``i``."""
        t = int(self.seg_task_ids[i])
        return t, int(i - sum(self.words[:t]))

    def windows(self, ids: np.ndarray, choices: np.ndarray) -> Dict[str, torch.Tensor]:
        """The reference's own gather of segments ``ids`` from the sessions
        ``choices``: X (B, L, C), Y (B, L, F), stats (B, C, 2), subject ids."""
        xs, ys, st, sid = [], [], [], []
        for i, c in zip(ids, choices):
            t, w = self.segment(int(i))
            r = self.rec_index[(self.session_keys[int(c)], f"task{t}")]
            o = int(self.word_onsets[t][w]) + self.shift
            xs.append(self.X_stack[r, o : o + self.L])
            y0 = int(self.seg_y_onsets[i])
            ys.append(self.Y_stack[t, y0 : y0 + self.L])
            st.append(self.stats_stack[r, w])
            sid.append(int(self.subject_of_rec[r]))
        return {"X": torch.stack(xs), "Y": torch.stack(ys), "stats": torch.stack(st),
                "subject_idxs": torch.as_tensor(sid, dtype=torch.long)}
