"""Batch sampling semantics (numpy only).

Copy of ``speech_decoding_tpu/data/sampling.py``, which mirrors the
reference's loaders [ref: speech_decoding/utils/get_dataloaders.py:4-86]:

  * Gwilliams default: an "epoch" is ``updates`` batches sampled WITH
    replacement (RandomSampler(replacement=True, num_samples=updates*bsz))
    [ref: get_dataloaders.py:57-62, configs/config.yaml:17];
  * Brennan: shuffled without-replacement batches over the split;
  * test: one full-test-set batch [ref: train.py:95-99];
  * within-batch segment ids are unique by construction (the reference
    asserts this per batch [ref: train.py:180-183]).

The same ``np.random.Generator`` gives the same ids as the JAX package.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


def random_split(n: int, split_ratio: float, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """torch.utils.data.random_split equivalent: shuffled index split
    [ref: train.py:119-123]."""
    perm = rng.permutation(n)
    n_train = int(n * split_ratio)
    return perm[:n_train], perm[n_train:]


def iter_updates_batches(pool: Sequence[int], batch_size: int, updates: int,
                         rng: np.random.Generator) -> Iterator[np.ndarray]:
    """``updates`` batches sampled with replacement across the epoch, but with
    unique segments WITHIN each batch (sampled without replacement per batch,
    satisfying the duplicate-segment guard by construction)."""
    pool = np.asarray(pool)
    if len(pool) < batch_size:
        raise ValueError(f"a pool of {len(pool)} segments cannot fill a batch of {batch_size}")
    for _ in range(updates):
        yield rng.choice(pool, size=batch_size, replace=False)


def iter_shuffled_batches(pool: Sequence[int], batch_size: int, rng: np.random.Generator,
                          drop_last: bool = False) -> Iterator[np.ndarray]:
    pool = np.asarray(pool)
    perm = rng.permutation(len(pool))
    end = (len(pool) // batch_size) * batch_size if drop_last else len(pool)
    for start in range(0, end, batch_size):
        batch = pool[perm[start : start + batch_size]]
        if len(batch) > 1:  # CLIP loss needs B > 1 [ref: loss.py:40]
            yield batch
