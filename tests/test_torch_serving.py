"""The port's micro-batching HTTP server: answers equal direct decode (and
the JAX server's), padded rows are inert, concurrent requests coalesce,
oversized requests chunk, and the error surface (400, 404, 413, 503)."""

import pytest

torch = pytest.importorskip("torch")

import io  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from speech_decoding_tpu.data.layout import ch_locations_2d  # noqa: E402
from speech_decoding_tpu.models import BrainEncoder as JaxEncoder  # noqa: E402
from speech_decoding_tpu_torch.inference import SpeechDecoder  # noqa: E402
from speech_decoding_tpu_torch.models.brain_encoder import BrainEncoder  # noqa: E402
from speech_decoding_tpu_torch.models.params_bridge import load_flax  # noqa: E402
from speech_decoding_tpu_torch.serving import (  # noqa: E402
    DecoderServer,
    MicroBatcher,
    MicroBatcherClosed,
    decode_request,
)

torch.set_num_threads(1)

C, T, F, S, BANK_N = 208, 40, 16, 3, 24


@pytest.fixture(scope="module")
def decoder():
    loc = ch_locations_2d("Gwilliams2022", cache=False)
    kw = dict(num_subjects=S, D1=16, D2=16, F=F, K=4)
    v = JaxEncoder(loc=loc, **kw).init(jax.random.PRNGKey(0), jnp.zeros((2, C, T)), jnp.zeros((2,), jnp.int32))
    enc = load_flax(BrainEncoder(loc=loc, **kw), jax.tree.map(np.asarray, v["params"]),
                    jax.tree.map(np.asarray, v["batch_stats"]))
    dec = SpeechDecoder(enc, use_fused_blocks=True, device="cpu")
    dec.set_bank(np.random.default_rng(7).normal(size=(BANK_N, F, T)).astype(np.float32))
    return dec


@pytest.fixture(scope="module")
def server(decoder):
    srv = DecoderServer(decoder, segment_shape=(C, T), max_batch=8, max_wait_ms=150.0).start()
    yield srv
    srv.shutdown()


def _batch(seed, b):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, C, T)).astype(np.float32), rng.integers(0, S, size=b).astype(np.int32)


def test_padded_rows_do_not_change_results(decoder):
    X, sidx = _batch(0, 3)
    direct_s, direct_i = decoder.decode(X, sidx, k=5)
    mb = MicroBatcher(decoder, (C, T), max_batch=8, max_wait_ms=1.0)
    try:
        s, i = mb.submit(X, sidx, k=5)
    finally:
        mb.close()
    np.testing.assert_array_equal(i, direct_i)
    np.testing.assert_allclose(s, direct_s, atol=1e-5)


def test_http_decode_roundtrip(server, decoder):
    X, sidx = _batch(1, 4)
    s, i = decode_request(server.host, server.port, X, sidx, k=3)
    ds, di = decoder.decode(X, sidx, k=3)
    assert s.shape == (4, 3) and i.dtype == np.int32
    np.testing.assert_array_equal(i, di)
    np.testing.assert_allclose(s, ds, atol=1e-5)


def test_concurrent_requests_coalesce(server, decoder):
    X, sidx = _batch(2, 8)
    ds, di = decoder.decode(X, sidx, k=4)
    before = server.batcher.dispatches
    results = [None] * 8

    def call(j):
        results[j] = decode_request(server.host, server.port, X[j : j + 1], sidx[j : j + 1], k=4)

    threads = [threading.Thread(target=call, args=(j,)) for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for j, (s, i) in enumerate(results):
        np.testing.assert_array_equal(i[0], di[j])
        np.testing.assert_allclose(s[0], ds[j], atol=1e-5)
    assert server.batcher.dispatches - before <= 4


def test_oversize_request_chunks(server, decoder):
    X, sidx = _batch(3, 19)  # max_batch=8 -> 3 dispatches incl. a padded tail
    s, i = decode_request(server.host, server.port, X, sidx, k=2)
    ds, di = decoder.decode(X, sidx, k=2)
    np.testing.assert_array_equal(i, di)
    np.testing.assert_allclose(s, ds, atol=1e-5)


def test_health_stats_and_errors(server):
    base = f"http://{server.host}:{server.port}"
    with urllib.request.urlopen(f"{base}/healthz") as r:
        h = json.loads(r.read())
    assert h == {"status": "ok", "bank_segments": BANK_N, "segment_shape": [C, T], "max_batch": 8}
    with urllib.request.urlopen(f"{base}/stats") as r:
        st = json.loads(r.read())
    assert st["rows"] >= 1 and st["dispatches"] >= 1 and st["rows_per_dispatch"] > 0

    buf = io.BytesIO()
    np.savez(buf, X=np.zeros((2, C + 1, T), np.float32), subject_idxs=np.zeros(2, np.int32))
    req = urllib.request.Request(f"{base}/decode", data=buf.getvalue(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400 and "(B, 208, 40)" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/nope")
    assert e.value.code == 404


def test_oversized_payload_is_413(decoder):
    srv = DecoderServer(decoder, segment_shape=(C, T), max_batch=4, max_payload_bytes=1024).start()
    try:
        X, sidx = _batch(4, 1)
        with pytest.raises(urllib.error.HTTPError) as e:
            decode_request(srv.host, srv.port, X, sidx)
        assert e.value.code == 413
    finally:
        srv.shutdown()


def test_503_after_shutdown(decoder):
    """A request that reaches a closed batcher gets 503 (retryable), and a
    direct submit raises MicroBatcherClosed instead of blocking."""
    srv = DecoderServer(decoder, segment_shape=(C, T), max_batch=4).start()
    srv.batcher.close()
    try:
        X, sidx = _batch(5, 2)
        with pytest.raises(urllib.error.HTTPError) as e:
            decode_request(srv.host, srv.port, X, sidx)
        assert e.value.code == 503 and json.loads(e.value.read())["retryable"] is True
        with pytest.raises(MicroBatcherClosed):
            srv.batcher.submit(X, sidx)
    finally:
        srv.shutdown()
