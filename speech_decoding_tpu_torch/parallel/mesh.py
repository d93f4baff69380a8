"""The process groups of the ("data", "model") grid, and batch placement.

Port of ``speech_decoding_tpu/parallel/mesh.py``. JAX builds a ("data",
"model") mesh over its devices and shards batches over "data". The port
runs one process a device, as ``torchrun`` launches it, so each axis is a
``torch.distributed`` process group:

  * without a grid the "data" axis is the default process group: rank r
    holds rows [r·b, (r+1)·b) of every global batch of W·b rows, and
    parameters, BatchNorm statistics and optimizer state are replicated;
  * ``make_grid({"data": d, "model": m})`` lays the W = d·m ranks out as
    JAX's ``reshape(d, m)`` does: rank r has data index r // m and model
    index r % m, so the model ranks of one data index are contiguous. Its
    ``data`` group joins the d ranks of one model index (they hold the same
    parameter blocks and different rows), its ``model`` group the m ranks
    of one data index (the same rows, each its block of every split
    parameter: ``parallel/sharding_rules.py``).

``DataGroup`` names the rank's place on the "data" axis, the rank's device
and the process group it spans (None: the default group); every
data-parallel function of the port takes one (None: a single process,
nothing synchronised). ``ModelGroup`` is the same record on the "model"
axis.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class DataGroup:
    """The "data" axis: ``world`` ranks, this one's ``rank`` among them, its
    ``device``, and the process group ``pg`` they form (None: the default
    group, every rank)."""

    world: int
    rank: int
    device: torch.device
    pg: Optional[dist.ProcessGroup] = None
    axis: ClassVar[str] = DATA_AXIS

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def block(self, n_rows: int) -> slice:
        """This rank's contiguous block of a global batch of ``n_rows``."""
        return rank_block(n_rows, self.world, self.rank)


class ModelGroup(DataGroup):
    """The "model" axis: the ``world`` = m ranks that hold the same rows and
    split the parameters column-wise, this one's model index ``rank``."""

    axis: ClassVar[str] = MODEL_AXIS


@dataclass(frozen=True)
class Grid:
    """This rank's place on both axes of a ``make_grid`` layout."""

    data: DataGroup
    model: ModelGroup


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


def make_grid(mesh_shape: Optional[Dict[str, int]] = None,
              device: Optional[Union[str, torch.device]] = None) -> Grid:
    """The ("data", "model") grid over the initialized process group, from
    JAX's ``tpu.mesh_shape`` dict (default: every rank on "data"). d·m must
    equal the world size. Every rank creates every sub-group, in the same
    order (gloo and NCCL hang otherwise), and keeps its two. ``device`` as
    in ``data_group``."""
    whole = data_group(device)
    shape = dict(mesh_shape or {DATA_AXIS: whole.world})
    unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(f"mesh_shape names unknown axes {sorted(unknown)}")
    d, m = int(shape.get(DATA_AXIS, 1)), int(shape.get(MODEL_AXIS, 1))
    if d < 1 or m < 1 or d * m != whole.world:
        raise ValueError(f"mesh {d}x{m} != {whole.world} processes")
    data_pgs = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    model_pgs = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    i, j = divmod(whole.rank, m)
    return Grid(data=DataGroup(d, i, whole.device, data_pgs[j]), model=ModelGroup(m, j, whole.device, model_pgs[i]))


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
    on the rank's device. On a grid pass ``grid.data``: every model rank of
    one data index gets the same rows."""
    blk = group.block(batch["X"].shape[axis])
    index = (slice(None),) * axis + (blk,)
    return put_batch({k: v[index] for k, v in batch.items()}, group.device)
