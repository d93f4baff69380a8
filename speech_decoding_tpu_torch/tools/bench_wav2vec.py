"""wav2vec2-large-xlsr-53 embedding throughput of the port, in audio-seconds
per second.

Port of the JAX package's ``tools/bench_wav2vec.py``: the default
``Wav2Vec2Config`` IS the xlsr-53 architecture (1024 hidden, 24 layers,
512-channel extractor, ~315M parameters), built with random weights from a
seeded ``torch.Generator`` (no pretrained weights are in the repository and
nothing is downloaded; throughput depends only on the architecture), and
the production embedding call (``FrozenWav2Vec2.last4_mean`` on ``batch``
1-s clips at 16 kHz, the ``embed_waveform`` compute shape
[ref: wav2vec_util.py:14-32]) is timed with CUDA events.

``measure_embed_rate`` is the one timing code for the embedder.

    python -m speech_decoding_tpu_torch.tools.bench_wav2vec [batch] [dtype] [--device cuda]

It prints one JSON line and writes no file.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Union

import torch

from speech_decoding_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from speech_decoding_tpu_torch.models.wav2vec_util import FrozenWav2Vec2
from speech_decoding_tpu_torch.tools import device_name, seconds_for
from speech_decoding_tpu_torch.utils.device import resolve_device

SR = 16000


def measure_embed_rate(
    batch: int = 16,
    dtype: str = "bfloat16",
    warmup: int = 3,
    rounds: int = 3,
    reps: int = 10,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    cfg: Optional[Wav2Vec2Config] = None,
) -> dict:
    """Audio-seconds/s of the last-4-layer-mean embedding of ``batch`` 1-s
    clips in ``dtype`` (the best per-call time over ``rounds`` rounds of
    ``reps`` calls, after ``warmup``), with the model built from ``seed``.
    ``cfg`` defaults to xlsr-53."""
    dev = resolve_device(device)
    cfg = cfg or Wav2Vec2Config()
    gen = torch.Generator(dev).manual_seed(seed)
    model = Wav2Vec2Model(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    w2v = FrozenWav2Vec2(model, dev, getattr(torch, dtype))
    wav = torch.randn((batch, SR), generator=gen, device=dev) * 0.1

    out = w2v.last4_mean(wav)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite wav2vec2 embedding")
    for _ in range(warmup):
        w2v.last4_mean(wav)
    best = min(seconds_for(lambda: w2v.last4_mean(wav), dev, reps) / reps for _ in range(rounds))
    return {
        "audio_s_per_s": batch / best, "ms_per_call": best * 1e3, "batch": batch, "clip_s": 1.0,
        "dtype": dtype, "params": n_params, "frames": int(out.shape[1]), "hidden": int(out.shape[2]),
        "clock": "CUDA events" if dev.type == "cuda" else "host",
        "device": device_name(dev),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=16, help="1-s clips per call")
    ap.add_argument("dtype", nargs="?", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps({"embed_rate": measure_embed_rate(a.batch, a.dtype, device=a.device)}), flush=True)


if __name__ == "__main__":
    main()
