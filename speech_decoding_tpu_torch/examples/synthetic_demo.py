"""Runnable end-to-end demo on synthetic data (no real datasets needed).

Port of the JAX package's ``examples/synthetic_demo.py``. Generates a tiny
fake Gwilliams2022 array-BIDS tree and its stimuli, builds the
preprocessing caches with a tiny random wav2vec2, trains a small brain
encoder for a few epochs through the port's CLI (``train.run``: Trainer,
retrieval eval, checkpoints), then serves top-k retrieval through
``SpeechDecoder``, against the dataset's bank and against a bank made from
audio clips by ``bank_from_audio``, and slides over a continuous recording
with ``decode_stream``. Runs on the card.

    python -m speech_decoding_tpu_torch.examples.synthetic_demo [workdir]
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np


def main(workdir: Optional[str] = None, device=None) -> Dict:
    """The demo in ``workdir`` (default: a new temporary directory) on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). Returns what it printed, as numbers."""
    from speech_decoding_tpu_torch import train as train_cli
    from speech_decoding_tpu_torch.data.gwilliams2022 import Gwilliams2022ShallowSplit
    from speech_decoding_tpu_torch.data.layout import ch_locations_2d
    from speech_decoding_tpu_torch.data.synthetic import make_config, make_gwilliams_tree, tiny_wav2vec
    from speech_decoding_tpu_torch.inference import SpeechDecoder, bank_from_audio
    from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from speech_decoding_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="sd_demo_")
    print(f"workdir: {workdir}")

    make_gwilliams_tree(workdir)
    cfg = make_config(workdir, "Gwilliams2022")
    cfg.epochs = 3
    cfg.batch_size = 8
    cfg.updates = 10
    cfg.D1, cfg.D2, cfg.K, cfg.F = 32, 32, 8, 16
    cfg.preprocs.last4layers = False  # tiny wav2vec feature dim = 16
    cfg.split_mode = "shallow"
    cfg.set_path("gwilliams.num_subjects", 2)
    cfg.set_path("gwilliams.num_sessions", 2)
    cfg.set_path("gwilliams.num_tasks", 2)
    # pin the checkpoint dir (the default is a fresh timestamped run dir
    # under outputs/, which the serving step below could not predict)
    cfg.set_path("checkpoint.dir", "checkpoints")

    # the caches, with the tiny wav2vec (a real run loads
    # facebook/wav2vec2-large-xlsr-53 instead)
    w2v = tiny_wav2vec(device=dev)
    build_cfg = cfg.copy()
    build_cfg.rebuild_dataset = True
    Gwilliams2022ShallowSplit(build_cfg, wav2vec=w2v, num_subjects=2, num_sessions=2, num_tasks=2, device=dev)

    history = train_cli.run(cfg, device=dev)

    # --- serving ---
    ds = Gwilliams2022ShallowSplit(cfg, num_subjects=2, num_sessions=2, num_tasks=2, device=dev)
    rng = np.random.default_rng(0)
    batch = ds.sample_batch(rng, np.arange(8))
    enc = BrainEncoder.from_config(cfg, ch_locations_2d("Gwilliams2022", workdir), ds.num_subjects)
    dec = SpeechDecoder.from_checkpoint(os.path.join(workdir, "checkpoints"), enc, bank=ds.Y, device=dev)
    _, ids = dec.decode(batch["X"], batch["subject_idxs"], k=5)
    hits = float(np.mean([int(i) in row for i, row in zip(np.arange(8), ids)]))
    print(f"top-5 retrieval against the full bank: {hits:.2f} (chance ≈ {5 / len(ds.Y):.2f})")

    # --- serving novel candidate audio and a continuous recording ---
    # bank_from_audio: raw clips -> (N, F, T) bank through the (tiny)
    # wav2vec2, the training audio chain as a serving op; decode_stream:
    # slide a window over a continuous recording and rank every window
    # against the bank
    seg_len = batch["X"].shape[-1]
    clips = (rng.normal(size=(6, 4000)) * 0.1).astype(np.float32)  # 0.25 s at 16 kHz
    bank = bank_from_audio(w2v, clips, 16000, segment_len=seg_len,
                           last4layers=False)  # the training flag above (tiny F=16)
    dec.set_bank(bank)
    X_cont = np.concatenate([batch["X"][i] for i in range(4)], axis=-1)
    _, stream_ids, onsets = dec.decode_stream(X_cont, 0, seg_len, hop=seg_len // 2, k=3, batch_size=4)
    print(f"stream decode: {len(onsets)} windows over {X_cont.shape[-1]} samples -> top-3 ids per window, "
          f"e.g. onset 0 -> {stream_ids[0].tolist()}")
    return {"history": history, "top5_hits": hits, "bank_shape": tuple(bank.shape), "stream_windows": len(onsets),
            "stream_ids": stream_ids}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
