"""Background batch production.

Port of the ``Prefetcher`` of ``speech_decoding_tpu/data/native_loader.py``.
The native segment gather of that module (``native/``) is not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


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
