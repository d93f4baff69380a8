"""The data-parallel process group and batch placement.

Port of ``speech_decoding_tpu/parallel/mesh.py``. JAX builds a ("data",
"model") mesh over its devices and shards batches over "data". The port
runs one process a device, as ``torchrun`` launches it, so the "data" axis
is the ``torch.distributed`` process group itself: rank r holds rows
[r·b, (r+1)·b) of every global batch of W·b rows, and parameters, BatchNorm
statistics and optimizer state are replicated on every rank. The "model"
axis (``parallel/sharding_rules.py``: parameters split over devices) is
not ported.

``DataGroup`` names the rank's place in the default process group and
the rank's device; every data-parallel function of the port takes one
(None: a single process, nothing synchronised).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataGroup:
    """The "data" axis, the default process group: ``world`` ranks, this
    one ``rank``, and its ``device``."""

    world: int
    rank: int
    device: torch.device

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def block(self, n_rows: int) -> slice:
        """This rank's contiguous block of a global batch of ``n_rows``."""
        return rank_block(n_rows, self.world, self.rank)


def rank_block(n_rows: int, world: int, rank: int) -> slice:
    """Rows [rank·b, (rank+1)·b) of a global batch of n_rows = world·b."""
    if n_rows % world:
        raise ValueError(f"{n_rows} rows are not divisible by {world} ranks")
    per = n_rows // world
    return slice(rank * per, (rank + 1) * per)


def rank_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (torchrun's variable; 0 when unset). Raises
    without a GPU, and when LOCAL_RANK names a card this machine does not
    have: two ranks must never share a card by wrapping around."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local} but this machine has {torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", local)


def data_group(device: Optional[Union[str, torch.device]] = None) -> DataGroup:
    """The "data" group of an initialized process group: ``device`` if the
    caller names one (``"cpu"`` for gloo ranks on the host, or one card
    shared by gloo ranks), else ``rank_device()``. NCCL needs a CUDA
    device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialized (parallel.multihost.init_distributed)")
    dev = rank_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    return DataGroup(world=dist.get_world_size(), rank=dist.get_rank(), device=dev)


def current_group(device: Optional[Union[str, torch.device]] = None) -> Optional[DataGroup]:
    """``data_group(device)`` when a process group exists, else None."""
    if dist.is_available() and dist.is_initialized():
        return data_group(device)
    return None


def put_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch dict on ``device``: numpy arrays and host tensors are copied
    over (through pinned memory, ``non_blocking``, to a CUDA device),
    tensors already there pass untouched; ``subject_idxs`` stays on the host
    as int32, where the per-subject kernel checks them."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if k == "subject_idxs":
            out[k] = t.to(torch.int32) if t.device.type == "cpu" else t
        elif t.device == device:
            out[k] = t
        elif device.type == "cuda" and t.device.type == "cpu":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def shard_batch(batch: Dict, group: DataGroup, axis: int = 0) -> Dict[str, torch.Tensor]:
    """The rank's contiguous block of a global batch along ``axis`` (1 for
    scan groups stacked (k, B, ...), as JAX's ``_put_stacked`` shards them),
    on the rank's device."""
    blk = group.block(batch["X"].shape[axis])
    index = (slice(None),) * axis + (blk,)
    return put_batch({k: v[index] for k, v in batch.items()}, group.device)
