"""WAV loading without torchaudio or soundfile.

Copy of ``speech_decoding_tpu/utils/wavio.py``: scipy.io.wavfile with
torchaudio-compatible normalization (integer PCM scaled to [-1, 1), shape
(channels, T) float32).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.io.wavfile

_SCALE = {np.int16: 1 << 15, np.int32: 1 << 31, np.uint8: 1 << 7}


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (waveform (channels, T) float32 in [-1, 1], sample_rate)."""
    sr, data = scipy.io.wavfile.read(path)
    if data.ndim == 1:
        data = data[:, None]
    data = data.T  # (channels, T)
    if data.dtype == np.uint8:  # 8-bit PCM is unsigned, offset binary
        out = (data.astype(np.float32) - 128.0) / 128.0
    elif data.dtype in (np.int16, np.int32):
        out = data.astype(np.float32) / float(_SCALE[data.dtype.type])
    else:
        out = data.astype(np.float32)
    return out, int(sr)
