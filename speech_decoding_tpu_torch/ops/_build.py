"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, at first use, under
``build/kernels/`` of the checkout (gitignored). The library file is keyed by
a hash of the source, of every shared header ``csrc/*.cuh`` and of the
flags, so an edited source or header rebuilds and an unchanged one loads
from disk. Libraries are loaded with ``ctypes``: every
pointer and the stream cross as ``c_void_p``, every C entry returns the
``cudaGetLastError()`` of its launch, and ``check`` raises on a non-zero
code. Nothing here includes PyTorch's headers, so a build takes seconds.

No JAX counterpart: the JAX package's Pallas kernels compile inside XLA.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

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


def build(names: Iterable[str]) -> List[str]:
    """Compile every named kernel whose library is not on disk yet, one
    ``nvcc`` per source, all started together. Returns the library paths."""
    names = list(names)
    with _lock:
        procs = [_start_build(n) for n in names if not os.path.exists(_lib_path(n))]
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
