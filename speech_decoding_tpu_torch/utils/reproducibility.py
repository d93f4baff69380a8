"""Reproducibility helpers.

Port of ``speech_decoding_tpu/utils/reproducibility.py``. The JAX package
returns a root ``jax.random`` key; the port seeds torch instead and returns
a CPU ``torch.Generator`` for host-side draws (spatial dropout centres).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 0) -> torch.Generator:
    """Seed ``random``, numpy and torch (every device) and return a CPU
    generator seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
