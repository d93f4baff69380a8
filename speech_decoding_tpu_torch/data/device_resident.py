"""Device-resident Gwilliams data path: train with no per-step host
transfer of segment data.

Port of ``speech_decoding_tpu/data/device_resident.py``. The host path
assembles every batch from host arrays and ships ~115 MB a step to the
device (X 19 MB + Y 94 MB + stats at B=64). Here the preprocessed
recordings, the unsegmented task embeddings and the per-word scale stats
live on the device as padded stacks; each step ships a few hundred bytes of
indices and one indexed gather builds the batch in device memory:

  * X: (R, C, T_max) stack over session-task recordings (or (R, T_max, C)
    channels-last); windows at onset indices (the reference's lazy onset
    slicing [ref: gwilliams2022.py:137-138]);
  * Y: (n_tasks, F, T_ymax) unsegmented task embeddings; word windows
    gathered the same way [ref: gwilliams2022.py:153-161];
  * per-word robust-scale stats packed (R, W_max, C, 2).

The JAX package gathers with a jitted ``vmap(dynamic_slice)``; the port
builds the time indices ``onsets_stack[rec, word] + arange(L)`` and gathers
with one advanced index per stack. Random-session sampling matches
``sample_batch`` exactly (the same rng draw sequence), so the host and the
device path give identical batches.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from speech_decoding_tpu_torch.utils.device import resolve_device
from speech_decoding_tpu_torch.utils.profiling import DATA_GATHER, DATA_INDEX, annotate


def _quantize_i16(stack: np.ndarray, channel_axis: int):
    """Per-(array, channel) symmetric int16 quantization over the time axis:
    returns (q int16, scale f32 (N, C)). /32766 with round-half-up keeps the
    rounded values inside int16 with no clip pass (the _ship_raw convention,
    ops/brain_preproc.py); ~90 dB SNR on raw M/EEG dynamic range.

    CONSUMES ``stack`` (quantizes in place): the full MEG-MASC stack is ~6 GB
    f32, and an out-of-place divide would transiently hold a second 6 GB copy
    on a path whose whole point is fitting big data."""
    time_axis = 1 if channel_axis == 2 else 2
    scale = np.abs(stack).max(axis=time_axis) / 32766.0  # (N, C)
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    denom = scale[:, None, :] if channel_axis == 2 else scale[:, :, None]
    np.divide(stack, denom, out=stack)
    stack += np.float32(0.5)
    np.floor(stack, out=stack)
    return stack.astype(np.int16), scale


def _stack(arrays, length: int, channels_last: bool) -> np.ndarray:
    """(N, C, length) or (N, length, C) f32 zeros holding each (C, T_i) array
    at its start."""
    C = arrays[0].shape[0]
    out = np.zeros((len(arrays), length, C) if channels_last else (len(arrays), C, length), np.float32)
    for i, a in enumerate(arrays):
        if channels_last:
            out[i, : a.shape[-1]] = np.asarray(a, np.float32).T
        else:
            out[i, :, : a.shape[-1]] = a
    return out


class DeviceResidentGwilliams:
    """Wraps a built Gwilliams2022 dataset; provides ``make_index_batch``
    (host, cheap) and ``gather`` (batch assembly on the device)."""

    def __init__(self, dataset, store_dtype: Union[str, torch.dtype] = torch.float32, channels_last: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        """channels_last: store the stacks time-major and emit (B, T, C) /
        (B, T, F) batches for a channels_last_io encoder (no layout
        transpose in the train step).

        store_dtype: float32, bfloat16 (half the memory, ~0.2% error), or
        int16 (half the memory with per-(array, channel) symmetric scales,
        ~90 dB SNR, dequantized in the gather); a torch dtype or its name.

        device: where the stacks live (default ``cuda``; raises without a
        GPU unless ``device="cpu"``)."""
        self.device = resolve_device(device)
        store_dtype = getattr(torch, store_dtype) if isinstance(store_dtype, str) else store_dtype
        if store_dtype not in (torch.float32, torch.bfloat16, torch.int16):
            raise ValueError(f"store_dtype must be float32, bfloat16 or int16, got {store_dtype}")
        self.ds = dataset
        self.channels_last = channels_last
        self.quantized = store_dtype == torch.int16
        L = dataset.seq_len_samp
        self.seq_len = L

        # ---- X stack ----
        keys = list(dataset.X.keys())
        self.keys = keys
        rec_index: Dict[Tuple[str, str], int] = {}
        recs = []
        for key in keys:
            for task, X in dataset.X[key].items():
                rec_index[(key, task)] = len(recs)
                recs.append(X)
        X_stack = _stack(recs, max(r.shape[-1] for r in recs) + L, channels_last)  # slack: onset+L in range
        self.x_scale = self.y_scale = None
        if self.quantized:
            X_stack, x_scale = _quantize_i16(X_stack, channel_axis=2 if channels_last else 1)
            self.x_scale = torch.from_numpy(x_scale).to(self.device)  # (R, C)
        self.X_stack = torch.from_numpy(X_stack).to(self.device, store_dtype)
        del X_stack
        self.rec_index = rec_index

        # ---- Y task stack (unsegmented; gathered by word onset) ----
        y_dict = np.load(os.path.join(dataset.preproc_dir, "y_dict.npy"), allow_pickle=True).item()
        tasks = sorted(y_dict.keys(), key=lambda s: int(s[-1]))
        Y_stack = _stack([y_dict[t] for t in tasks], max(y.shape[-1] for y in y_dict.values()) + L, channels_last)
        if self.quantized:
            Y_stack, y_scale = _quantize_i16(Y_stack, channel_axis=2 if channels_last else 1)
            self.y_scale = torch.from_numpy(y_scale).to(self.device)  # (n_tasks, F)
        self.Y_stack = torch.from_numpy(Y_stack).to(self.device, store_dtype)
        del Y_stack

        # ---- per-word scale stats packed (R, W_max, C, 2) ----
        C = recs[0].shape[0]
        W_max = max(len(dataset.meg_onsets[key][task]) for key in keys for task in dataset.X[key])
        stats = np.zeros((len(recs), W_max, C, 2), np.float32)
        stats[..., 1] = 1.0
        onsets = np.zeros((len(recs), W_max), np.int64)
        for (key, task), r in rec_index.items():
            s = dataset.scale_stats[key][task]
            stats[r, : len(s)] = s
            o = dataset.meg_onsets[key][task]
            onsets[r, : len(o)] = o
        self.stats_stack = torch.from_numpy(stats).to(self.device)
        self.onsets_stack = torch.from_numpy(onsets).to(self.device)

        # subject of each recording, on the host: batches carry their
        # subject ids on the host, where the per-subject kernel checks them
        self.subject_of_rec = np.asarray(
            [int(np.where(dataset.valid_subjects == key.split("_")[0])[0][0])
             for (key, task), _ in sorted(rec_index.items(), key=lambda kv: kv[1])],
            np.int32,
        )
        self.seg_task_ids = np.asarray(dataset.segment_task_ids)
        self.seg_y_onsets = np.asarray(dataset.segment_y_onsets)
        self._arange = torch.arange(L, device=self.device)

    @property
    def nbytes(self) -> int:
        """Bytes of the device stacks (X, Y, stats, onsets, scales)."""
        ts = [self.X_stack, self.Y_stack, self.stats_stack, self.onsets_stack, self.x_scale, self.y_scale]
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def make_index_batch(
        self,
        rng: np.random.Generator,
        segment_ids: np.ndarray,
        choices: np.ndarray = None,
    ) -> Dict[str, np.ndarray]:
        """Host-side index selection — the SAME rng draw sequence as
        Gwilliams2022DatasetBase.sample_batch (one integers(len(keys)) draw
        per segment; key order matches, so ``choices`` from
        ``dataset.draw_choices`` selects identical sessions)."""
        with annotate(DATA_INDEX):
            if choices is None:
                choices = self.ds.draw_choices(rng, len(segment_ids))
            rec_idx, word_idx = [], []
            for i, choice in zip(segment_ids, choices):
                i_in_task, task = self.ds.segment_to_task(int(i))
                key = self.keys[int(choice)]
                rec_idx.append(self.rec_index[(key, task)])
                word_idx.append(i_in_task)
            return {
                "rec_idx": np.asarray(rec_idx, np.int32),
                "word_idx": np.asarray(word_idx, np.int32),
                "task_idx": self.seg_task_ids[segment_ids],
                "y_onset": self.seg_y_onsets[segment_ids],
            }

    def _window(self, stack: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """stack[rows[b]] windowed at starts[b] over L samples: (B, L, C)
        from a channels-last stack, (B, C, L) from a channels-first one."""
        t = starts[:, None] + self._arange  # (B, L)
        if self.channels_last:
            return stack[rows[:, None], t]
        # an advanced index, a slice, an advanced index: the indexed dims go first
        return stack[rows[:, None], :, t].transpose(1, 2)

    def gather(self, idx: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Batch assembly on the device from the int32 indices of
        ``make_index_batch``: X, Y and scale_stats f32 on the device,
        subject_idxs int32 on the host. The indices cross in one copy from
        pinned memory, which waits for nothing: a copy from pageable memory
        waits for every kernel queued before it on the stream, the train
        steps' included."""
        with annotate(DATA_GATHER):
            dev = self.device
            host = torch.from_numpy(np.stack([np.asarray(idx[k], np.int64)
                                              for k in ("rec_idx", "word_idx", "task_idx", "y_onset")]))
            if dev.type == "cuda":
                host = host.pin_memory()
            rec, word, task, y_on = host.to(dev, non_blocking=True)
            X = self._window(self.X_stack, rec, self.onsets_stack[rec, word]).float()
            Y = self._window(self.Y_stack, task, y_on).float()
            if self.quantized:  # int16 storage: per-(array, channel) dequant
                sx, sy = self.x_scale[rec], self.y_scale[task]
                if self.channels_last:
                    X, Y = X * sx[:, None, :], Y * sy[:, None, :]
                else:
                    X, Y = X * sx[:, :, None], Y * sy[:, :, None]
            return {
                "X": X.contiguous(),
                "Y": Y.contiguous(),
                "scale_stats": self.stats_stack[rec, word],
                "subject_idxs": torch.from_numpy(self.subject_of_rec[np.asarray(idx["rec_idx"])]),
            }
