"""Multi-process bootstrap and host-local batches.

Port of ``speech_decoding_tpu/parallel/multihost.py`` onto
``torch.distributed`` with torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) in place of
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
One process a card:

    torchrun --nproc-per-node=4 -m speech_decoding_tpu_torch.train \\
        dataset=Gwilliams2022 tpu.multihost=true checkpoint.dir=/shared/ckpt

The backend is ``nccl`` on CUDA and ``gloo`` when the caller asks for the
CPU. Each process loads only its ``batch_size / world`` rows a step
(``host_local_slice`` of the global batch that every rank draws alike);
its block stays on its card (``local_batch``): unlike JAX, there is no
global array to assemble, since the step's collectives (``parallel
.collectives``) carry everything that crosses ranks.

``spawn_ranks`` starts W ranks of a function on this machine (the tests'
and ``chip_smoke.py``'s launcher).
"""

from __future__ import annotations

import os
import socket
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from speech_decoding_tpu_torch.parallel.mesh import DataGroup, put_batch, rank_block, rank_device
from speech_decoding_tpu_torch.utils.logging import cprint

def _backend(device) -> str:
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Initialize the default process group from torchrun's environment
    (``env://``), unless one exists already (a launcher's own init is
    tolerated). ``backend``: ``nccl``, or ``gloo`` when ``device`` is the
    CPU. With NCCL the rank's card (``cuda:LOCAL_RANK``) becomes the
    current device. Returns whether the group spans more than one process."""
    if not (dist.is_available() and dist.is_initialized()):
        backend = backend or _backend(device)
        if backend == "nccl":
            torch.cuda.set_device(rank_device() if device is None else torch.device(device))
        dist.init_process_group(backend, init_method="env://")
    return _world() > 1


def maybe_init_distributed(args, device=None) -> bool:
    """CLI hook: initialize ``torch.distributed`` when the run is
    multi-process; returns whether it is. Runs before the first use of the
    card. Activation:

      * ``tpu.multihost=true``: an explicit opt-in; the coordinates come
        from torchrun's environment, or from a launcher that initialized the
        process group itself;
      * ``MASTER_ADDR`` in the environment (a torchrun launch);
      * neither (the default): a no-op, one process.

    It fails loudly rather than let each process train alone as its own
    primary (duplicate W&B runs, concurrent checkpoint writes, a
    ``batch_size`` no longer global): coordinates that end in one process
    raise, except ``WORLD_SIZE=1`` without the flag (a launcher that
    templates the variables onto one process)."""
    want = bool(args.select("tpu.multihost", False))
    env = os.environ.get("MASTER_ADDR")
    if not (want or env):
        return False
    if env:
        nproc = os.environ.get("WORLD_SIZE")
        try:
            active = init_distributed(device)
        except (RuntimeError, ValueError) as e:
            cprint(f"torch.distributed: {e}", "yellow")
            active = _world() > 1
        if not active and (want or nproc != "1"):
            raise RuntimeError(
                "MASTER_ADDR is set (multi-process launch), but torch.distributed did not reach world_size>1: "
                "the coordinator is unreachable, WORLD_SIZE is unset or 1, or the process group was already "
                "initialized single-process."
            )
        return active
    # the flag without coordinates: only a launcher's own init can make this
    # a multi-process run; never fall through to one process
    if not (dist.is_available() and dist.is_initialized()):
        try:
            dist.init_process_group(_backend(device), init_method="env://")
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                "tpu.multihost=true but torch.distributed found no coordinates: launch with torchrun "
                "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK set for each process), or drop "
                "tpu.multihost=true for a single-process run."
            ) from e
    if _world() <= 1:
        raise RuntimeError(
            f"tpu.multihost=true but torch.distributed initialized single-process (world_size={_world()}); "
            "drop tpu.multihost=true or launch one process per card with torchrun."
        )
    return True


def host_local_slice(n_rows: int) -> slice:
    """This process's contiguous block of a global batch of ``n_rows``
    (rank order, as ``DataGroup.block``)."""
    world = _world()
    return rank_block(n_rows, world, dist.get_rank() if world > 1 else 0)


def local_batch(batch: Dict, group: DataGroup) -> Dict[str, torch.Tensor]:
    """The counterpart of JAX's ``global_batch_from_host_local``: the
    rank's block (``host_local_slice`` rows) on the rank's device. Nothing
    is assembled; the step's collectives make the batch global."""
    return put_batch(batch, group.device)


# -- a launcher for W ranks on this machine ----------------------------------------------


def free_port() -> int:
    """A TCP port free on localhost at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: str, torch_threads: int, args, queue) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    if torch_threads:
        torch.set_num_threads(torch_threads)
    try:
        init_distributed(backend=backend)
        try:
            queue.put((rank, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo", timeout: float = 600.0,
                torch_threads: int = 0) -> List:
    """Run ``fn(*args)`` in ``world`` fresh processes (spawned, not
    forked), each a rank of one process group on localhost (torchrun's
    variables set, ``LOCAL_RANK`` = rank), and return their results by
    rank. ``fn`` must be importable (a module-level function) and return
    picklable host values (numpy rather than tensors, which would cross as
    shared-memory handles). Raises, with the rank's traceback, when a rank
    fails or the ranks outlast ``timeout`` seconds; every process it
    started has ended when it returns."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, torch_threads, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks did not finish in {timeout} s")
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0]} and reported nothing")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]
