"""HTTP serving for trained decoders: a micro-batching server around
``SpeechDecoder``.

Port of ``speech_decoding_tpu/serving.py`` (framework-free; same endpoints,
payloads and error surface). The decoder runs at one batch shape: each
request may carry any number of segment rows, and the ``MicroBatcher``
coalesces concurrently-arriving rows into padded ``(max_batch, C, T)``
dispatches. Padding rows are inert: eval-mode BatchNorm uses running
statistics and every per-row op — the subject matmul, channel softmax,
convolutions, bank retrieval — is row-local, so a row's result is
independent of its batch neighbours (test:
tests/test_torch_serving.py::test_padded_rows_do_not_change_results).

Endpoints (payloads are ``.npz`` bytes — numpy-native, no extra deps):

  POST /decode    body: npz with ``X`` (B, C, T) f32, ``subject_idxs`` (B,)
                  int, optional scalar ``k`` (default 10)
                  -> npz with ``scores`` (B, k) f32, ``ids`` (B, k) i32
  GET  /healthz   -> JSON {status, bank_segments, segment_shape, max_batch}
  GET  /stats     -> JSON micro-batching counters (requests, rows,
                  dispatches, rows/dispatch)

CLI: ``python -m speech_decoding_tpu_torch.serve torch_checkpoint=... serve.bank=bank.npz``.

Non-goals: this server is a deployment building block behind a real frontend
— it deliberately ships no TLS, no authentication, no rate limiting and no
request tracing. It does guard itself: request bodies above
``max_payload_bytes`` are rejected with 413 before buffering, socket reads
time out (``request_timeout_s``), and during shutdown in-flight submissions
fail fast with 503 instead of blocking forever.
"""

from __future__ import annotations

import io
import json
import queue
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from speech_decoding_tpu_torch.utils.logging import cprint

_SHUTDOWN = object()


class MicroBatcherClosed(RuntimeError):
    """Raised to callers whose requests race or trail a shutdown; the HTTP
    layer maps it to 503 (retryable: the server is going away)."""


class MicroBatcher:
    """Coalesces concurrent decode requests into fixed-shape batches.

    Rows from requests that arrive within ``max_wait_ms`` of each other (or
    while a batch is in flight) are concatenated, padded to ``max_batch``
    rows — the ONE shape the decoder is warmed up and measured at — and
    dispatched together; each caller gets back exactly its rows. Requests
    with different ``k`` are grouped separately (one top-k width per
    decode call).
    """

    def __init__(
        self,
        decoder,
        segment_shape: Tuple[int, int],
        max_batch: int = 64,
        max_wait_ms: float = 3.0,
    ):
        self.decoder = decoder
        self.segment_shape = (int(segment_shape[0]), int(segment_shape[1]))
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: queue.Queue = queue.Queue()
        # set (under _lock) before the sentinel is enqueued so a submit()
        # racing close() fails fast instead of enqueueing behind the drain
        # and blocking its caller forever
        self._closed = False
        # counters (read by /stats and tests)
        self.requests = 0
        self.rows = 0
        self.dispatches = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- client side -----------------------------------------------------
    def submit(self, X: np.ndarray, subject_idxs: np.ndarray, k: int = 10):
        """Blocking: returns (scores, ids) numpy arrays for this request's
        rows. Raises ValueError on shape mismatch."""
        X = np.asarray(X, np.float32)
        subject_idxs = np.asarray(subject_idxs, np.int32)
        if X.ndim != 3 or X.shape[1:] != self.segment_shape:
            raise ValueError(
                f"X must be (B, C, T) = (B, {self.segment_shape[0]}, "
                f"{self.segment_shape[1]}), got {tuple(X.shape)}"
            )
        if subject_idxs.shape != (X.shape[0],):
            raise ValueError(
                f"subject_idxs must be ({X.shape[0]},), got "
                f"{tuple(subject_idxs.shape)}"
            )
        if X.shape[0] == 0:
            return np.zeros((0, int(k)), np.float32), np.zeros((0, int(k)), np.int32)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise MicroBatcherClosed("MicroBatcher shut down")
            self.requests += 1
            self.rows += X.shape[0]
            self._q.put((X, subject_idxs, int(k), fut))
        return fut.result()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._q.put(_SHUTDOWN)
        self._thread.join(timeout=10.0)

    # ---- dispatcher ------------------------------------------------------
    def _run(self) -> None:
        import time

        while True:
            item = self._q.get()
            if item is _SHUTDOWN:
                self._drain_shutdown()
                return
            group = [item]
            rows = item[0].shape[0]
            # coalescing window: keep draining until the padded batch is
            # full or max_wait elapses (later arrivals ride along free
            # while the previous dispatch occupies the device anyway)
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    self._dispatch(group)
                    self._drain_shutdown()
                    return
                group.append(nxt)
                rows += nxt[0].shape[0]
            self._dispatch(group)

    def _drain_shutdown(self) -> None:
        """Fail any requests still queued behind the shutdown sentinel so
        their callers unblock instead of waiting forever."""
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                return
            if it is _SHUTDOWN:
                continue
            it[3].set_exception(MicroBatcherClosed("MicroBatcher shut down"))

    def _dispatch(self, group) -> None:
        # group by k: one top-k width per decode call
        by_k: Dict[int, list] = {}
        for it in group:
            by_k.setdefault(it[2], []).append(it)
        for k, items in by_k.items():
            try:
                self._decode_padded(k, items)
            except BaseException as e:  # surface on every waiting caller
                for *_1, fut in items:
                    if not fut.done():
                        fut.set_exception(e)

    def _decode_padded(self, k: int, items) -> None:
        C, T = self.segment_shape
        X = np.concatenate([it[0] for it in items])
        sidx = np.concatenate([it[1] for it in items])
        n = X.shape[0]
        scores = np.empty((n, k), np.float32)
        ids = np.empty((n, k), np.int32)
        for lo in range(0, n, self.max_batch):
            hi = min(lo + self.max_batch, n)
            pad = self.max_batch - (hi - lo)
            Xp = np.concatenate([X[lo:hi], np.zeros((pad, C, T), np.float32)])
            sp = np.concatenate([sidx[lo:hi], np.zeros((pad,), np.int32)])
            s, i = self.decoder.decode(Xp, sp, k=k)
            scores[lo:hi] = s[: hi - lo]
            ids[lo:hi] = i[: hi - lo]
            with self._lock:
                self.dispatches += 1
        off = 0
        for Xi, _sidx, _k, fut in items:
            b = Xi.shape[0]
            fut.set_result((scores[off : off + b], ids[off : off + b]))
            off += b


class DecoderServer:
    """Threaded HTTP server exposing a ``SpeechDecoder`` (see module
    docstring for the endpoints). ``port=0`` binds an ephemeral port
    (``self.port`` after construction)."""

    def __init__(
        self,
        decoder,
        segment_shape: Tuple[int, int],
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        max_wait_ms: float = 3.0,
        max_payload_bytes: int = 256 * 1024 * 1024,
        request_timeout_s: float = 30.0,
    ):
        self.batcher = MicroBatcher(
            decoder, segment_shape, max_batch=max_batch, max_wait_ms=max_wait_ms
        )
        self.decoder = decoder
        server = self

        max_payload = int(max_payload_bytes)

        class Handler(BaseHTTPRequestHandler):
            # socket read/write deadline (socketserver.StreamRequestHandler
            # applies it in setup()); a stalled client can't pin a handler
            # thread forever
            timeout = float(request_timeout_s)

            def log_message(self, *a):  # quiet request log
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path == "/healthz":
                    bank_n = server.decoder.bank_size
                    self._json(
                        200,
                        {
                            "status": "ok" if bank_n else "no bank",
                            "bank_segments": bank_n,
                            "segment_shape": list(server.batcher.segment_shape),
                            "max_batch": server.batcher.max_batch,
                        },
                    )
                elif self.path == "/stats":
                    b = server.batcher
                    with b._lock:
                        req, rows, disp = b.requests, b.rows, b.dispatches
                    self._json(
                        200,
                        {
                            "requests": req,
                            "rows": rows,
                            "dispatches": disp,
                            "rows_per_dispatch": rows / max(disp, 1),
                        },
                    )
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self) -> None:
                if self.path != "/decode":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > max_payload:
                        # reject BEFORE buffering: close the connection so
                        # the oversized body is never read into memory
                        self.close_connection = True
                        self._json(
                            413,
                            {
                                "error": (
                                    f"payload {n} bytes exceeds "
                                    f"max_payload_bytes={max_payload}"
                                )
                            },
                        )
                        return
                    payload = np.load(
                        io.BytesIO(self.rfile.read(n)), allow_pickle=False
                    )
                    X = payload["X"]
                    sidx = payload["subject_idxs"]
                    k = int(payload["k"]) if "k" in payload else 10
                    scores, ids = server.batcher.submit(X, sidx, k)
                except (ValueError, KeyError, OSError) as e:
                    self._json(400, {"error": str(e)})
                    return
                except MicroBatcherClosed as e:
                    # server is draining: retryable, not an internal error
                    self._json(503, {"error": str(e), "retryable": True})
                    return
                except Exception as e:  # dispatch-side failure: report, keep serving
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                out = io.BytesIO()
                np.savez(out, scores=scores, ids=ids)
                body = out.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self) -> "DecoderServer":
        """Serve in a background thread (tests / embedding)."""
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._serve_thread.start()
        cprint(f"DecoderServer listening on {self.host}:{self.port}", "cyan")
        return self

    def serve_forever(self) -> None:
        cprint(f"DecoderServer listening on {self.host}:{self.port}", "cyan")
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)


def decode_request(
    host: str, port: int, X: np.ndarray, subject_idxs: np.ndarray, k: int = 10
) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal std-lib client for POST /decode (also the test harness)."""
    import urllib.request

    buf = io.BytesIO()
    np.savez(
        buf,
        X=np.asarray(X, np.float32),
        subject_idxs=np.asarray(subject_idxs, np.int32),
        k=np.asarray(k),
    )
    req = urllib.request.Request(
        f"http://{host}:{port}/decode",
        data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"},
        method="POST",
    )
    with urllib.request.urlopen(req) as r:
        out = np.load(io.BytesIO(r.read()), allow_pickle=False)
        return out["scores"], out["ids"]
