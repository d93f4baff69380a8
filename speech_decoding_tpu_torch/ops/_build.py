"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, at first use, under
``build/kernels/`` of the checkout (gitignored). The library file is keyed by
a hash of the source, of every shared header ``csrc/*.cuh`` and of the
flags, so an edited source or header rebuilds and an unchanged one loads
from disk. Nothing here includes PyTorch's headers, so a build takes seconds.

Libraries are loaded with ``ctypes`` and called through ``Library``, the one
launch path of the kernel wrappers: each wrapper registers its library's
table ``{entry: argument types before the stream}`` once (``LIBRARIES``
holds them all, and a CPU test holds every table against the ``extern "C"``
declarations of ``csrc/``), and ``lib(entry, device, *args)`` passes a
tensor as its ``data_ptr()`` and ``None`` as a null pointer, appends the
device's current stream, calls with that device current, and raises
through ``check`` on the ``cudaGetLastError()`` the entry returns. Every
pointer and the stream cross as ``c_void_p``.

Several processes may build at once (the ranks of a data-parallel run
start together): a build holds an exclusive ``flock`` on
``build/kernels/.lock`` (released by the kernel if the process dies), so
the second process finds the libraries on disk; each library is written
under a temporary name and renamed into place, so no process loads a
half-written file.

No JAX counterpart: the JAX package's Pallas kernels compile inside XLA.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# the argument types of the tables
PTR, INT, LONG, FLOAT, DOUBLE = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_double

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(SRC_DIR, f"{name}.cu"), *sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    proc.tmp, proc.out, proc.kname = tmp, out, name  # type: ignore[attr-defined]
    return proc


def _finish_build(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {proc.kname}.cu:\n{log.decode(errors='replace')}")
    os.replace(proc.tmp, proc.out)


@contextlib.contextmanager
def _build_lock():
    """This process's threads, then every process on the machine, one at a
    time."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str]) -> List[str]:
    """Compile every named kernel whose library is not on disk yet, one
    ``nvcc`` per source, all started together. Returns the library paths."""
    names = list(names)
    missing = [n for n in names if not os.path.exists(_lib_path(n))]
    if missing:
        with _build_lock():
            procs = [_start_build(n) for n in missing if not os.path.exists(_lib_path(n))]
            for p in procs:
                _finish_build(p)
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build([name])[0]
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # CUDA builds of PyTorch


def current_stream(device: int) -> int:
    """The current stream of CUDA device ``device``, as an address."""
    return _raw_stream(device) if _raw_stream is not None else torch.cuda.current_stream(device).cuda_stream


def on(device: int):
    """``device`` as the current CUDA device (a no-op when it already is)."""
    return contextlib.nullcontext() if device == torch.cuda.current_device() else torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sms(device: torch.device) -> int:
    """The SM count of CUDA ``device``."""
    return sm_count(device.index if device.index is not None else torch.cuda.current_device())


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte-aligned base (a copy where it is not),
    as kernels with 16-byte loads read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


LIBRARIES: Dict[str, "Library"] = {}  # library name -> its Library, as the wrappers register them


class Library:
    """The C entries of ``csrc/<name>.cu``: ``signatures`` maps each entry
    to the argument types before its trailing stream. The library loads at
    the first call, each entry's ``argtypes`` are set once."""

    def __init__(self, name: str, signatures: Dict[str, Sequence]):
        self.name, self.signatures = name, signatures
        self._fns = {}
        LIBRARIES[name] = self

    def argtypes(self, entry: str) -> list:
        return [*self.signatures[entry], PTR]

    def _fn(self, entry: str):
        fn = self._fns.get(entry)
        if fn is None:
            fn = getattr(load(self.name), entry)
            fn.argtypes = self.argtypes(entry)
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        return fn

    def __call__(self, entry: str, device: torch.device, *args) -> None:
        """Launch ``entry`` on the current stream of ``device`` (a CUDA
        device or its index): a tensor passes as its ``data_ptr()``, ``None``
        as a null pointer, anything else as it is."""
        fn = self._fn(entry)
        index = device if isinstance(device, int) else device.index
        with on(index):
            err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], current_stream(index))
        check(err, f"{self.name} {entry}")
