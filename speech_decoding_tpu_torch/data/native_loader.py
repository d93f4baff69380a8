"""Host batch assembly: the native segment gather and a background
prefetcher.

Port of ``speech_decoding_tpu/data/native_loader.py``. The reference
assembles batches in 6 DataLoader worker processes
[ref: speech_decoding/utils/get_dataloaders.py:70-85]; here a multithreaded
C++ window gather (``native/segment_gather.cpp``, the JAX package's source,
read as it is) copies (C, L) windows out of the memory-resident recordings
into one (B, C, L) batch, with the GIL released for the call, and one Python
thread prefetches batches while the device computes.

The library is built with ``g++`` at first use into ``build/native/`` of the
checkout (gitignored), keyed by a hash of the source and the flags; the JAX
package writes its own build into ``native/`` and this module never touches
it. There is no quiet fallback: where the library cannot be built,
``gather_segments`` raises. ``gather_segments_plain`` is the numpy version
with the same arithmetic, for the tests and for callers that ask for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_PATH = os.path.join(_REPO, "native", "segment_gather.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_PF = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_SIGNATURES = {
    # (srcs, src_T, onsets, B, C, L, out, num_threads)
    "sd_gather_segments": [ctypes.POINTER(_PF), ctypes.POINTER(_I64), ctypes.POINTER(_I64), _I64, _I64, _I64,
                           _PF, ctypes.c_int],
    # (srcs, src_T, onsets, B, C, L, baseline_len, out, num_threads)
    "sd_gather_segments_baseline": [ctypes.POINTER(_PF), ctypes.POINTER(_I64), ctypes.POINTER(_I64), _I64, _I64,
                                    _I64, _I64, _PF, ctypes.c_int],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256()
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsegment_gather-{h.hexdigest()[:16]}.so")


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises RuntimeError when
    the source is missing or ``g++`` cannot build it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SRC_PATH):
            raise RuntimeError(f"the native gather source {SRC_PATH} is missing")
        path = lib_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC_PATH, "-lpthread"], check=True,
                               capture_output=True)
            except FileNotFoundError as e:
                raise RuntimeError("g++ not found: the native segment gather cannot be built") from e
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"g++ failed on {SRC_PATH}:\n{e.stderr.decode(errors='replace')}") from e
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return _lib


def _checked(sources: Sequence[np.ndarray], onsets: Sequence[int], seq_len: int, baseline_len: int,
             out: Optional[np.ndarray]):
    """Sources as C-contiguous f32 (C, T_b) arrays (copied only where they
    are not), onsets as ints, the clamped baseline and the output buffer;
    raises on a window outside its recording."""
    if len(sources) != len(onsets) or not len(sources):
        raise ValueError(f"{len(sources)} sources for {len(onsets)} onsets")
    srcs = [s if (s.dtype == np.float32 and s.flags["C_CONTIGUOUS"]) else np.ascontiguousarray(s, np.float32)
            for s in sources]
    C = srcs[0].shape[0]
    ons = [int(o) for o in onsets]
    for s, o in zip(srcs, ons):
        if s.ndim != 2 or s.shape[0] != C:
            raise ValueError(f"sources must be (C={C}, T) arrays, got {s.shape}")
        if o < 0 or o + seq_len > s.shape[1]:
            raise ValueError(f"window [{o}, {o + seq_len}) lies outside a recording of {s.shape[1]} samples")
    # reference baseline slice `win[..., :baseline_len]` clips to the window
    # [ref: brennan2018.py:140]; clamp so the native kernel never reads past it
    baseline_len = min(int(baseline_len), int(seq_len))
    shape = (len(srcs), C, int(seq_len))
    if out is None:
        out = np.empty(shape, np.float32)
    elif out.shape != shape or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous float32 {shape} array")
    return srcs, ons, baseline_len, out


def gather_segments(
    sources: Sequence[np.ndarray],
    onsets: Sequence[int],
    seq_len: int,
    baseline_len: int = 0,
    num_threads: int = 0,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """out[b] = sources[b][:, onsets[b]:onsets[b]+seq_len], optionally
    baseline-corrected (each (b, c) row minus the mean of its first
    ``baseline_len`` samples), by the native library on ``num_threads``
    threads (0: one per core). Sources are (C, T_b) float arrays, copied to
    C-contiguous f32 only where they are not."""
    srcs, ons, baseline_len, out = _checked(sources, onsets, seq_len, baseline_len, out)
    lib = get_lib()
    B, C = len(srcs), srcs[0].shape[0]
    ptrs = (_PF * B)(*[s.ctypes.data_as(_PF) for s in srcs])
    Ts = (_I64 * B)(*[s.shape[1] for s in srcs])
    ons_c = (_I64 * B)(*ons)
    out_p = out.ctypes.data_as(_PF)
    if baseline_len:
        lib.sd_gather_segments_baseline(ptrs, Ts, ons_c, B, C, seq_len, baseline_len, out_p, num_threads)
    else:
        lib.sd_gather_segments(ptrs, Ts, ons_c, B, C, seq_len, out_p, num_threads)
    return out


def gather_segments_plain(
    sources: Sequence[np.ndarray],
    onsets: Sequence[int],
    seq_len: int,
    baseline_len: int = 0,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The numpy loop of the JAX package's fallback, with the native
    library's arithmetic: the baseline mean is a sequential f64 sum (a
    cumulative sum) divided in f64 and rounded to f32, then subtracted in
    f32, so the result equals ``gather_segments`` bit for bit."""
    srcs, ons, baseline_len, out = _checked(sources, onsets, seq_len, baseline_len, out)
    for b, (src, on) in enumerate(zip(srcs, ons)):
        win = src[:, on : on + seq_len]
        if baseline_len:
            acc = np.cumsum(win[:, :baseline_len], axis=-1, dtype=np.float64)[:, -1]
            win = win - (acc / baseline_len).astype(np.float32)[:, None]
        out[b] = win
    return out


class Prefetcher:
    """Runs a batch-producing iterator in a background thread, keeping up to
    ``depth`` ready batches (optionally already moved to the device by
    ``transform``). Order is kept; an error in the producer is raised on the
    consumer side; ``close()`` (called when the consuming loop ends, normally
    or not) stops the producer. The lock is released while torch copies or
    launches, so production overlaps device work."""

    def __init__(self, batch_iter: Iterator, transform: Optional[Callable] = None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def put(item) -> bool:
            # stop-aware bounded put: an abandoned consumer would otherwise
            # leave this thread blocked forever, pinning ``depth`` batches
            # and the source iterator for the life of the process
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def run():
            try:
                for item in batch_iter:
                    if self._stop.is_set():
                        break
                    if not put(self._transform(item) if self._transform else item):
                        break
            except BaseException as e:  # raised again on the consumer side
                self._err = e
            finally:
                try:
                    close = getattr(batch_iter, "close", None)
                    if close is not None:
                        close()
                except Exception as e:  # a generator's clean-up failed: report it
                    self._err = self._err or e
                finally:
                    put(self._done)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the producer and drop queued batches. Idempotent."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self._stop.set()

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._done:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()
