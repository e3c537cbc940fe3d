"""The port's HTTP serving host (multimodal_auv_torch/serve_http.py): a
live loopback server over an exported artifact must return exactly what a
direct artifact.predict call returns, for exact, padded (ragged) and
chunked batch sizes, plus the error paths. The cases of
tests/test_serve_http.py, on the CPU; one artifact is exported (in chunks
of one draw, to keep the program small) and loaded once, and every server
of the module serves that loaded artifact; ``main`` loads it from its
directory in a subprocess.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.serve_http import ArtifactService, make_server
from multimodal_auv_torch.serving import (
    export_predict_artifact,
    load_predict_artifact,
)

ARCH = ArchConfig.micro()
B, S, MC = 4, 32, 4
CLASSES = ["Sand", "Mud", "Rock"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for this module: its graphs are tiny, and with
    the suite's parallel workers the idle threads of each small op's
    parallel region spin on cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One artifact, exported and loaded once: (its directory, the loaded
    ServingArtifact)."""
    bundle = make_multimodal_bundle(len(CLASSES), BNNPriorSpec(),
                                    torch.Generator().manual_seed(0), ARCH,
                                    device="cpu")
    d = str(tmp_path_factory.mktemp("artifact"))
    export_predict_artifact(bundle, d, batch_size=B, num_mc_samples=MC,
                            image_size=S, class_names=CLASSES, mc_chunk=1)
    return d, load_predict_artifact(d, device="cpu")


@pytest.fixture(scope="module")
def server_url(artifact):
    d, art = artifact
    server = make_server(art, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", art
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"main": rng.integers(0, 255, (n, S, S, 3), dtype=np.uint8),
            "bathy": rng.integers(0, 255, (n, S, S, 3), dtype=np.uint8),
            "sss": rng.integers(0, 255, (n, S, S, 1), dtype=np.uint8)}


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(url, body, path="/predict"):
    req = urllib.request.Request(url + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz_and_meta(server_url):
    url, _ = server_url
    status, health = _get(url, "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["batch_size"] == B and health["num_mc_samples"] == MC
    status, meta = _get(url, "/meta")
    assert status == 200 and meta["class_names"] == CLASSES


@pytest.mark.parametrize("n", [B, 2, 2 * B + 1])
def test_predict_matches_direct_call(server_url, n):
    """Exact (n==B), padded (n<B) and chunked (n>2B) requests must equal a
    direct ArtifactService call with the same seed — which itself is pinned
    to artifact.predict below."""
    url, art = server_url
    arrays = _arrays(n, seed=n)
    status, got = _post(url, _npz_bytes(seed=np.uint32(7), **arrays))
    assert status == 200 and got["n"] == n

    svc = ArtifactService(art)
    want = svc.predict(arrays, n, seed=7)
    np.testing.assert_array_equal(got["predicted"],
                                  want["predicted"].astype(int))
    np.testing.assert_allclose(got["predictive_uncertainty"],
                               want["predictive_uncertainty"], rtol=1e-6)
    np.testing.assert_allclose(got["aleatoric_uncertainty"],
                               want["aleatoric_uncertainty"], rtol=1e-6)
    np.testing.assert_allclose(got["mean_prob"], want["mean_prob"],
                               atol=1e-6)
    assert got["predicted_labels"] == [CLASSES[i] for i in got["predicted"]]
    assert all(len(row) == len(CLASSES) for row in got["mean_prob"])


def test_service_padding_matches_artifact_mask(server_url):
    """The service's pad+mask rule must equal artifact.predict with an
    explicit mask (the serving-loop rule it mirrors)."""
    _, art = server_url
    svc = ArtifactService(art)
    arrays = _arrays(2, seed=3)
    got = svc.predict(arrays, 2, seed=11)

    key = 11  # a seeded request's first chunk draws with the seed itself
    padded = [np.concatenate([a, np.repeat(a[-1:], B - 2, 0)])
              for a in (arrays["main"], arrays["bathy"], arrays["sss"])]
    mask = np.array([1, 1, 0, 0], np.float32)
    want = art.predict(*padded, key=key, mask=mask)
    np.testing.assert_array_equal(got["predicted"], want["predicted"][:2])
    np.testing.assert_allclose(got["mean_prob"], want["mean_prob"][:2],
                               atol=1e-7)


def test_seed_reproducible_fresh_draws_by_default(server_url):
    url, _ = server_url
    arrays = _arrays(B, seed=5)
    body = _npz_bytes(seed=np.uint32(9), **arrays)
    _, a = _post(url, body)
    _, b = _post(url, body)
    assert a["mean_prob"] == b["mean_prob"]  # same seed -> same draws
    # no seed -> fresh draws per request (the artifact's call counter)
    free = _npz_bytes(**arrays)
    _, c = _post(url, free)
    _, e = _post(url, free)
    assert c["mean_prob"] != e["mean_prob"]


@pytest.mark.parametrize("body,msg", [
    (b"not an npz", "not a readable"),
    (b"", "not a readable"),
])
def test_predict_malformed_body(server_url, body, msg):
    url, _ = server_url
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, body)
    assert ei.value.code == 400
    assert msg in json.loads(ei.value.read())["error"]


def test_predict_bad_arrays(server_url):
    url, _ = server_url
    arrays = _arrays(2)
    missing = {k: v for k, v in arrays.items() if k != "sss"}
    for bad, msg in [
        (missing, "missing required array"),
        ({**arrays, "main": arrays["main"].astype(np.float32)},
         "must be uint8"),
        ({**arrays, "bathy": arrays["bathy"][:, :8]}, "shape"),
        ({**arrays, "sss": arrays["sss"][:1]}, "row counts differ"),
        ({k: v[:0] for k, v in arrays.items()}, "empty batch"),
    ]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, _npz_bytes(**bad))
        assert ei.value.code == 400, bad.keys()
        assert msg in json.loads(ei.value.read())["error"]


def test_unknown_paths(server_url):
    url, _ = server_url
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url, "/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, b"x", path="/nope")
    assert ei.value.code == 404


def test_concurrent_requests(server_url):
    """Device dispatch is lock-serialized; concurrent clients must all get
    correct, independent answers."""
    url, art = server_url
    bodies = [(n, _npz_bytes(seed=np.uint32(n), **_arrays(B, seed=n)))
              for n in range(4)]
    results = {}

    def hit(n, body):
        results[n] = _post(url, body)[1]

    threads = [threading.Thread(target=hit, args=nb) for nb in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc = ArtifactService(art)
    for n, _ in bodies:
        want = svc.predict(_arrays(B, seed=n), B, seed=n)
        np.testing.assert_allclose(results[n]["mean_prob"],
                                   want["mean_prob"], atol=1e-6)


def test_metrics_endpoint(server_url):
    """GET /metrics: Prometheus text exposition whose counters move with
    traffic (requests by route/status, rows, device calls, latency
    histogram sum==count consistency)."""
    import re

    url, _ = server_url

    def scrape():
        req = urllib.request.Request(url + "/metrics")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            return r.read().decode()

    def value(text, name):
        m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
        return float(m.group(1)) if m else 0.0

    before = scrape()
    _post(url, _npz_bytes(seed=np.uint32(1), **_arrays(B, seed=1)))
    with pytest.raises(urllib.error.HTTPError):
        _post(url, b"garbage")
    # counters are recorded after the response is flushed — poll briefly
    import time as _t

    ok = 'auv_requests_total{route="/predict",status="200"}'
    bad = 'auv_requests_total{route="/predict",status="400"}'
    deadline = _t.monotonic() + 10
    after = scrape()
    while (value(after, bad) != value(before, bad) + 1
           and _t.monotonic() < deadline):
        _t.sleep(0.05)
        after = scrape()
    assert value(after, ok) == value(before, ok) + 1
    assert value(after, bad) == value(before, bad) + 1
    assert value(after, "auv_rows_total") == value(before, "auv_rows_total") + B
    assert (value(after, "auv_device_calls_total")
            == value(before, "auv_device_calls_total") + 1)
    assert (value(after, "auv_request_duration_seconds_count")
            > value(before, "auv_request_duration_seconds_count"))
    # histogram +Inf bucket equals the count
    inf = re.search(r'_bucket\{le="\+Inf"\} (\d+)', after).group(1)
    assert float(inf) == value(after, "auv_request_duration_seconds_count")


class TestMicroBatching:
    @pytest.fixture(scope="class")
    def batched_server(self, artifact):
        server = make_server(artifact[1], "127.0.0.1", 0,
                             batch_window_ms=300.0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.server_address[:2]
        # warm the program so the coalescing window isn't eaten by compile
        _post(f"http://{host}:{port}",
              _npz_bytes(seed=np.uint32(0), **_arrays(B)))
        yield f"http://{host}:{port}", server.service
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)

    def test_concurrent_small_requests_share_one_device_call(
            self, batched_server):
        """B concurrent 1-row seedless requests within the window must be
        packed into ONE program execution, and each client still gets its
        own correct row count back."""
        url, svc = batched_server
        calls_before = svc.metrics.device_calls_total
        results = {}

        def hit(i):
            results[i] = _post(url, _npz_bytes(**_arrays(1, seed=100 + i)))[1]

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(B)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)

        assert len(results) == B
        for i, out in results.items():
            assert out["n"] == 1 and len(out["predicted"]) == 1
            assert len(out["mean_prob"][0]) == len(CLASSES)
        calls = svc.metrics.device_calls_total - calls_before
        assert calls < B, f"no coalescing happened ({calls} device calls)"
        assert svc.metrics.coalesced_requests_total >= 2

    def test_seeded_requests_bypass_batcher_and_stay_reproducible(
            self, batched_server):
        """A seeded request must not be co-batched: its draws are a pure
        function of (seed, chunk) regardless of concurrent traffic."""
        url, svc = batched_server
        arrays = _arrays(2, seed=42)
        body = _npz_bytes(seed=np.uint32(5), **arrays)
        _, a = _post(url, body)

        # same request under heavy seedless concurrency
        noise = [threading.Thread(
            target=lambda j=j: _post(url, _npz_bytes(**_arrays(1, seed=j))))
            for j in range(3)]
        for t in noise:
            t.start()
        _, b_out = _post(url, body)
        for t in noise:
            t.join(timeout=120)
        assert a["mean_prob"] == b_out["mean_prob"]

        # and it matches the direct (unbatched) service path
        want = svc.predict(arrays, 2, seed=5)
        np.testing.assert_allclose(a["mean_prob"], want["mean_prob"],
                                   atol=1e-6)

    def test_full_batch_requests_skip_coalescing(self, batched_server):
        """n == B requests go straight through (nothing to coalesce)."""
        url, svc = batched_server
        coalesced_before = svc.metrics.coalesced_requests_total
        _, out = _post(url, _npz_bytes(**_arrays(B, seed=7)))
        assert out["n"] == B
        assert svc.metrics.coalesced_requests_total == coalesced_before


def test_batcher_shutdown_fails_stragglers():
    """A request enqueued behind the shutdown sentinel must be failed
    immediately (error set, event set) — not left parked on the client's
    wait timeout. The sentinel is posted once the batcher is inside the
    (blocking) dispatch of the first request's group."""
    import multimodal_auv_torch.serve_http as sh

    entered, release = threading.Event(), threading.Event()

    class BlockingArtifact:
        batch_size, image_size, mode, meta = 2, S, "mc", {}

        def predict_async(self, *chunk, key=None, mask=None):
            entered.set()
            release.wait(timeout=30)
            return chunk[0].shape[0]

        def fetch(self, n):
            return {"predicted": np.zeros(n, np.int32),
                    "predictive_uncertainty": np.zeros(n, np.float32),
                    "aleatoric_uncertainty": np.zeros(n, np.float32),
                    "mean_prob": np.full((n, 3), 1 / 3, np.float32)}

    svc = sh.ArtifactService(BlockingArtifact(), batch_window_ms=1.0)
    a1 = [np.zeros((1, S, S, c), np.uint8) for _, c in
          (("main", 3), ("bathy", 3), ("sss", 1))]
    p1 = sh._Pending(a1, 1)  # occupies the batcher (predict blocks)
    p2 = sh._Pending(a1, 1)  # straggler arriving during shutdown
    svc._queue.put(p1)
    assert entered.wait(timeout=10), "the batcher never dispatched p1"
    svc._queue.put(None)  # shutdown sentinel
    svc._queue.put(p2)    # behind the sentinel
    release.set()
    assert p2.event.wait(timeout=10), "straggler never released"
    assert isinstance(p2.error, RuntimeError)
    assert p1.event.wait(timeout=10) and p1.error is None
    svc._batcher.join(timeout=10)
    assert not svc._batcher.is_alive()


def test_serve_client(server_url):
    """ServeClient (serve_client.py): the reference protocol client must
    round-trip predictions identically to raw posts, surface server errors
    as ServeError, and emit reference-schema CSV rows."""
    from multimodal_auv_torch.serve_client import (
        CSV_COLUMNS,
        ServeClient,
        ServeError,
    )

    url, art = server_url
    c = ServeClient(url)
    assert c.healthz()["status"] == "ok"
    assert c.meta()["class_names"] == CLASSES
    assert "auv_requests_total" in c.metrics_text()

    arrays = _arrays(3, seed=21)
    out = c.predict(arrays["main"], arrays["bathy"], arrays["sss"], seed=13)
    svc = ArtifactService(art)
    want = svc.predict(arrays, 3, seed=13)
    np.testing.assert_array_equal(out["predicted"], want["predicted"])
    np.testing.assert_allclose(out["mean_prob"], want["mean_prob"],
                               atol=1e-6)

    rows = list(c.predict_rows(["a.jpg", "b.jpg", "c.jpg"],
                               arrays["main"], arrays["bathy"],
                               arrays["sss"], seed=13))
    assert [tuple(r.keys()) for r in rows] == [CSV_COLUMNS] * 3
    assert [r["Predicted Class"] for r in rows] == out["predicted"].tolist()

    with pytest.raises(ValueError, match="uint8"):
        c.predict(arrays["main"].astype(np.float32), arrays["bathy"],
                  arrays["sss"])
    with pytest.raises(ServeError) as ei:
        c.predict(arrays["main"][:2], arrays["bathy"], arrays["sss"])
    assert ei.value.status == 400 and "row counts" in ei.value.detail


def test_oversized_body_rejected_with_413(tmp_path_factory, server_url):
    """A Content-Length beyond the server limit must be refused BEFORE
    buffering (413), bounding host memory against buggy/hostile clients."""
    url, art = server_url
    small = make_server(art, "127.0.0.1", 0, max_body_mb=0.001)  # ~1 KB
    t = threading.Thread(target=small.serve_forever, daemon=True)
    t.start()
    try:
        host, port = small.server_address[:2]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://{host}:{port}", b"x" * 4096)
        assert ei.value.code == 413
        assert "exceeds limit" in json.loads(ei.value.read())["error"]
        # under the limit still parses (400: not an npz, but it was READ)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://{host}:{port}", b"x" * 100)
        assert ei.value.code == 400
    finally:
        small.shutdown()
        small.server_close()
        t.join(timeout=10)


def test_fuzz_bodies_never_kill_the_server(server_url):
    """Adversarial/corrupt bodies (random bytes, truncated npz, npz with
    hostile member names/dtypes/shapes) must always produce an orderly
    4xx and leave the server serving."""
    url, _ = server_url
    rng = np.random.default_rng(0)

    bodies = [bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
              for n in (0, 1, 7, 512, 9000)]
    good = _npz_bytes(**_arrays(2, seed=1))
    bodies += [good[:k] for k in (10, len(good) // 2, len(good) - 3)]
    # hostile npz contents
    buf = io.BytesIO()
    np.savez(buf, main=np.zeros((2, S, S, 3), np.int64),  # wrong dtype
             bathy=np.zeros((2, S, S, 3), np.uint8),
             sss=np.zeros((2, S, S, 1), np.uint8))
    bodies.append(buf.getvalue())
    buf = io.BytesIO()
    np.savez(buf, **{"../../etc/passwd": np.zeros(3, np.uint8)})
    bodies.append(buf.getvalue())
    buf = io.BytesIO()
    np.savez(buf, main=np.zeros((0, S, S, 3), np.uint8),
             bathy=np.zeros((0, S, S, 3), np.uint8),
             sss=np.zeros((0, S, S, 1), np.uint8))
    bodies.append(buf.getvalue())

    for body in bodies:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, body)
        assert 400 <= ei.value.code < 500, len(body)
        json.loads(ei.value.read())  # error payload is valid JSON

    # still alive and correct afterward
    status, out = _post(url, _npz_bytes(seed=np.uint32(2), **_arrays(B)))
    assert status == 200 and out["n"] == B


def test_main_serves_and_drains_on_sigterm(artifact):
    """``python -m multimodal_auv_torch.serve_http`` on the CPU: it loads the
    artifact directory, logs its bound address, answers /healthz and a
    request, and on SIGTERM drains and exits 0."""
    import os
    import re
    import signal
    import subprocess
    import sys
    import time

    d, _ = artifact
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_auv_torch.serve_http",
         "--artifact", d, "--port", "0", "--device", "cpu"],
        cwd=repo, env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        url = None
        while url is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line and proc.poll() is not None:
                break
            m = re.search(r"on (http://[\d.]+:\d+)", line)
            url = m.group(1) if m else None
        assert url, "the server never logged its address"
        status, health = _get(url, "/healthz")
        assert status == 200 and health["platforms"] == ["cpu"]
        status, out = _post(url, _npz_bytes(seed=np.uint32(3),
                                            **_arrays(2, seed=4)))
        assert status == 200 and out["n"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
