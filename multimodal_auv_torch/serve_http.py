"""HTTP serving host for exported predict artifacts (port of
``multimodal_auv_tpu/serve_http.py``).

This module turns a serving artifact (serving.py: the ``torch.export``ed
predict programs + state) into a long-lived network service with nothing
but the standard library: a ``ThreadingHTTPServer`` exposing

    GET  /healthz    liveness + artifact summary (metadata only — use
                     --warmup to pay the first-dispatch cost at startup)
    GET  /meta       the artifact's meta.json (batch size, mc, classes...)
    GET  /metrics    Prometheus text: requests/rows/device-call counters,
                     latency histogram, coalescing efficiency
    POST /predict    one batch -> JSON predictions + uncertainties

With ``--batch_window_ms W`` the server micro-batches: concurrent
seedless requests smaller than the program batch wait up to W ms and
are packed into ONE device call (fan-in from many small clients at the
cost of bounded latency); seeded requests always run alone so their
reproducibility never depends on co-tenants.

``/predict`` accepts an ``.npz`` body (``numpy.savez`` of uint8 NHWC
arrays ``main``, ``bathy``, ``sss`` — the exact arrays the packed loader
produces) and returns the reference CSV schema as JSON: predicted class,
predictive (variance-family) and aleatoric uncertainty per row, plus the
mean softmax. Any row count is accepted: requests smaller than the
artifact's static batch are padded + masked (the in-process serving
loop's rule, engine/predict.py), larger ones are chunked sequentially.
Device dispatch is serialized with a lock — one program, one card;
HTTP I/O and npz decode overlap across threads.

Seed semantics match ``ServingArtifact.predict``: by default every
request draws fresh MC weight samples (a per-artifact counter folded
into the export seed, ``serving.fold_seed``); a client needing
reproducibility sends an explicit ``seed`` (uint32 scalar) in the npz and
gets the same draws for the same seed, independent of request order.

Run:  python -m multimodal_auv_torch.serve_http --artifact DIR [--host H]
      [--port P] [--device cuda|cpu]
      (multimodal-auv-torch-serve once the package is installed)
Test: tests/test_torch_serve_http.py drives a live server over a loopback
socket and pins every response field to a direct artifact.predict call.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from multimodal_auv_torch.serving import fold_seed

logger = logging.getLogger(__name__)

_MODALITIES = (("main", 3), ("bathy", 3), ("sss", 1))


class Metrics:
    """Lock-protected serving counters with Prometheus text exposition
    (``GET /metrics``). Everything a dashboard needs to see batching
    efficiency: requests vs device calls (coalescing collapses the
    former into the latter), rows served, request latency histogram."""

    BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
               10.0, 30.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: dict = {}  # (route, status) -> count
        self.rows_total = 0
        self.device_calls_total = 0
        self.coalesced_requests_total = 0
        self._hist = [0] * (len(self.BUCKETS) + 1)
        self._hist_sum = 0.0
        self._hist_count = 0

    def observe_request(self, route: str, status: int, seconds: float):
        with self._lock:
            k = (route, int(status))
            self.requests[k] = self.requests.get(k, 0) + 1
            self._hist_sum += seconds
            self._hist_count += 1
            for i, le in enumerate(self.BUCKETS):
                if seconds <= le:
                    self._hist[i] += 1
                    break
            else:
                self._hist[-1] += 1

    def add_rows(self, n: int):
        with self._lock:
            self.rows_total += int(n)

    def add_device_call(self):
        with self._lock:
            self.device_calls_total += 1

    def add_coalesced(self, n_requests: int):
        with self._lock:
            self.coalesced_requests_total += int(n_requests)

    def render(self) -> str:
        with self._lock:
            lines = [
                "# HELP auv_requests_total HTTP requests by route and status",
                "# TYPE auv_requests_total counter",
            ]
            for (route, status), c in sorted(self.requests.items()):
                lines.append(f'auv_requests_total{{route="{route}",'
                             f'status="{status}"}} {c}')
            lines += [
                "# HELP auv_rows_total prediction rows served",
                "# TYPE auv_rows_total counter",
                f"auv_rows_total {self.rows_total}",
                "# HELP auv_device_calls_total compiled-program executions",
                "# TYPE auv_device_calls_total counter",
                f"auv_device_calls_total {self.device_calls_total}",
                "# HELP auv_coalesced_requests_total requests served via "
                "the micro-batcher",
                "# TYPE auv_coalesced_requests_total counter",
                f"auv_coalesced_requests_total {self.coalesced_requests_total}",
                "# HELP auv_request_duration_seconds request latency",
                "# TYPE auv_request_duration_seconds histogram",
            ]
            acc = 0
            for le, c in zip(self.BUCKETS, self._hist):
                acc += c
                lines.append(
                    f'auv_request_duration_seconds_bucket{{le="{le}"}} {acc}')
            lines.append('auv_request_duration_seconds_bucket{le="+Inf"} '
                         f"{self._hist_count}")
            lines.append(f"auv_request_duration_seconds_sum {self._hist_sum}")
            lines.append(
                f"auv_request_duration_seconds_count {self._hist_count}")
            return "\n".join(lines) + "\n"


class _Pending:
    """One coalescible request waiting for the micro-batcher."""

    __slots__ = ("arrays", "n", "event", "result", "error")

    def __init__(self, arrays, n):
        self.arrays, self.n = arrays, n
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class ArtifactService:
    """Request-shape handling around one loaded ``ServingArtifact``:
    pad+mask short batches, chunk long ones, serialize device calls.

    ``batch_window_ms > 0`` additionally enables dynamic micro-batching
    for artifacts with a static batch size: concurrent SEEDLESS requests
    smaller than the program batch are held up to the window and packed
    into ONE device call (they share that call's fresh draws — exactly
    the packed serving loop's semantics for rows of one batch). Seeded
    requests always bypass the batcher: reproducibility is per-request
    (seed, chunk) and must not depend on who else is in flight."""

    def __init__(self, artifact, batch_window_ms: float = 0.0):
        self.artifact = artifact
        self._lock = threading.Lock()
        self.metrics = Metrics()
        self.batch_window_s = max(0.0, float(batch_window_ms)) / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._batcher = None
        if self.batch_window_s > 0 and self.artifact.batch_size != "poly":
            self._batcher = threading.Thread(
                target=self._batch_loop, name="auv-micro-batcher",
                daemon=True)
            self._batcher.start()

    def close(self):
        if self._batcher is not None:
            self._queue.put(None)
            self._batcher.join(timeout=10)
            self._batcher = None
        # a data-sharded artifact's shard workers (restarted by a later
        # call, so an artifact shared with another server stays usable)
        close = getattr(self.artifact, "close", None)
        if close is not None:
            close()

    # -- helpers -----------------------------------------------------------

    def _parse_npz(self, body: bytes):
        try:
            npz = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            raise ValueError(f"body is not a readable .npz: {e}") from e
        arrays = {}
        s = self.artifact.image_size
        n = None
        for name, ch in _MODALITIES:
            if name not in npz:
                raise ValueError(f"npz missing required array {name!r} "
                                 f"(need {[m for m, _ in _MODALITIES]})")
            a = npz[name]
            if a.dtype != np.uint8:
                raise ValueError(f"{name} must be uint8, got {a.dtype}")
            if a.ndim != 4 or a.shape[1:] != (s, s, ch):
                raise ValueError(
                    f"{name} shape {a.shape} != (n, {s}, {s}, {ch})")
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError("main/bathy/sss row counts differ")
            arrays[name] = a
        if n == 0:
            raise ValueError("empty batch")
        seed = None
        if "seed" in npz:
            seed = int(np.asarray(npz["seed"]).reshape(()))
        return arrays, n, seed

    def _key_for(self, seed, chunk_index: int):
        """Per-chunk seed. With an explicit seed the draws are a pure
        function of (seed, chunk_index); without one the artifact's
        fresh-draw counter applies (key=None)."""
        if seed is None:
            return None
        return fold_seed(seed, chunk_index) if chunk_index else seed

    def _device_predict(self, chunk, key, mask):
        # lock covers only the async dispatch: request k+1's compute
        # overlaps request k's device->host fetch (the HTTP analogue of
        # predict_batches' one-batch-lagged loop)
        with self._lock:
            handle = self.artifact.predict_async(*chunk, key=key, mask=mask)
        self.metrics.add_device_call()
        return self.artifact.fetch(handle)

    def predict(self, arrays, n: int, seed=None) -> dict:
        """Run ``n`` rows through the artifact, chunking/padding to its
        batch size. Returns numpy results trimmed to the real rows."""
        b = self.artifact.batch_size
        step = n if b == "poly" else int(b)
        outs = []
        for ci, lo in enumerate(range(0, n, step)):
            valid = min(step, n - lo)
            chunk = [arrays[m][lo:lo + valid] for m, _ in _MODALITIES]
            mask = None
            if valid < step:  # ragged tail: pad with the last row + mask
                pad = step - valid
                chunk = [np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                         for c in chunk]
                mask = np.zeros((step,), np.float32)
                mask[:valid] = 1.0
            out = self._device_predict(chunk, self._key_for(seed, ci), mask)
            outs.append({k: v[:valid] for k, v in out.items()
                         if k != "csv_cols"})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    # -- dynamic micro-batching ----------------------------------------------

    def _finish_group(self, inflight):
        """Fetch a dispatched group's results and release its clients."""
        if inflight is None:
            return
        group, handle, err = inflight
        try:
            if err is None:
                out = self.artifact.fetch(handle)
                out = {k: v for k, v in out.items() if k != "csv_cols"}
                lo = 0
                for p in group:
                    p.result = {k: v[lo:lo + p.n] for k, v in out.items()}
                    lo += p.n
            else:
                raise err
        except Exception as e:  # pragma: no cover - device failure
            for p in group:
                p.error = e
        finally:
            if len(group) > 1:
                self.metrics.add_coalesced(len(group))
            for p in group:
                p.event.set()

    def _batch_loop(self):
        """Collect coalescible requests for up to the window (or until the
        program batch is full), dispatch ONE device call per group, split
        results. One group's fetch is LAGGED behind the next group's
        dispatch (the serving-loop rule): under sustained load the
        device→host copy of group k overlaps group k+1's compute."""
        b = int(self.artifact.batch_size)
        carry = None
        inflight = None  # (group, dispatch handle, dispatch error)
        while True:
            if carry is not None:
                item, carry = carry, None
            elif inflight is not None:
                # a group is on the device: poll briefly, then drain it
                try:
                    item = self._queue.get(timeout=0.001)
                except queue.Empty:
                    self._finish_group(inflight)
                    inflight = None
                    continue
            else:
                item = self._queue.get()
            if item is None:
                self._finish_group(inflight)
                # shutdown: fail any stragglers instead of leaving their
                # client threads parked on the wait timeout
                while True:
                    try:
                        p = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    if p is not None:
                        p.error = RuntimeError("server shutting down")
                        p.event.set()
            group, rows = [item], item.n
            deadline = time.monotonic() + self.batch_window_s
            while rows < b:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post for the outer loop
                    break
                if rows + nxt.n > b:  # doesn't fit: lead the next group
                    carry = nxt
                    break
                group.append(nxt)
                rows += nxt.n
            handle, err = None, None
            try:
                cat = [np.concatenate([p.arrays[mi] for p in group])
                       for mi in range(len(_MODALITIES))]
                mask = None
                if rows < b:
                    pad = b - rows
                    cat = [np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                           for c in cat]
                    mask = np.zeros((b,), np.float32)
                    mask[:rows] = 1.0
                with self._lock:
                    handle = self.artifact.predict_async(*cat, key=None,
                                                         mask=mask)
                self.metrics.add_device_call()
            except Exception as e:  # pragma: no cover - dispatch failure
                err = e
            self._finish_group(inflight)  # lagged: after the new dispatch
            inflight = (group, handle, err)

    def _coalesced_predict(self, arrays, n: int) -> dict:
        p = _Pending([arrays[m] for m, _ in _MODALITIES], n)
        self._queue.put(p)
        # generous: a device call is seconds at most; never park a client
        if not p.event.wait(timeout=300):
            raise RuntimeError("micro-batcher timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def handle_predict(self, body: bytes) -> dict:
        arrays, n, seed = self._parse_npz(body)
        if (self._batcher is not None and seed is None
                and n < int(self.artifact.batch_size)):
            out = self._coalesced_predict(arrays, n)
        else:
            out = self.predict(arrays, n, seed)
        self.metrics.add_rows(n)
        meta = self.artifact.meta
        names = meta.get("class_names")
        resp = {
            "n": int(n),
            "predicted": out["predicted"].astype(int).tolist(),
            "predictive_uncertainty":
                out["predictive_uncertainty"].astype(float).tolist(),
            "aleatoric_uncertainty":
                out["aleatoric_uncertainty"].astype(float).tolist(),
            "mean_prob": np.round(out["mean_prob"].astype(float),
                                  6).tolist(),
            "mode": meta.get("mode", "mc"),
        }
        if names:
            resp["predicted_labels"] = [names[i] for i in resp["predicted"]]
        return resp

    def summary(self) -> dict:
        m = self.artifact.meta
        return {"status": "ok", "mode": m.get("mode", "mc"),
                "batch_size": m.get("batch_size"),
                "image_size": m.get("image_size"),
                "num_mc_samples": m.get("num_mc_samples"),
                "num_classes": m.get("num_classes"),
                "platforms": m.get("platforms")}


class _Handler(BaseHTTPRequestHandler):
    # the service is attached to the server object by make_server()
    protocol_version = "HTTP/1.1"
    _status = 500  # overwritten by _send_raw; default covers a dead pipe

    def _send(self, code: int, payload: dict):
        raw = json.dumps(payload).encode()
        self._send_raw(code, raw, "application/json")

    def _send_raw(self, code: int, raw: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)
        self._status = code

    def do_GET(self):
        svc: ArtifactService = self.server.service
        t0 = time.monotonic()
        route = self.path.split("?")[0]
        if route == "/healthz":
            self._send(200, svc.summary())
        elif route == "/meta":
            self._send(200, svc.artifact.meta)
        elif route == "/metrics":
            self._send_raw(200, svc.metrics.render().encode(),
                           "text/plain; version=0.0.4")
        else:
            self._send(404, {"error": f"unknown path {self.path!r}"})
            route = "other"  # bound metrics label cardinality vs scanners
        svc.metrics.observe_request(route, self._status,
                                    time.monotonic() - t0)

    def do_POST(self):
        svc: ArtifactService = self.server.service
        t0 = time.monotonic()
        route = self.path.split("?")[0]
        if route != "/predict":
            self._send(404, {"error": f"unknown path {self.path!r}"})
            route = "other"  # bound metrics label cardinality
        else:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > self.server.max_body_bytes:
                    # bound memory: a buggy/hostile client must not be able
                    # to make the host buffer an arbitrary body. The unread
                    # body would desync a keep-alive socket — close it.
                    self.close_connection = True
                    self._send(413, {
                        "error": f"body {length} bytes exceeds limit "
                                 f"{self.server.max_body_bytes} (raise "
                                 f"--max_body_mb if intentional)"})
                    svc.metrics.observe_request(route, self._status,
                                                time.monotonic() - t0)
                    return
                body = self.rfile.read(length)
                self._send(200, svc.handle_predict(body))
            except ValueError as e:  # malformed request
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - server-side failure
                logger.error("predict request failed", exc_info=True)
                self._send(500, {"error": repr(e)})
        svc.metrics.observe_request(route, self._status,
                                    time.monotonic() - t0)

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.info("%s - %s", self.address_string(), fmt % args)


class _Server(ThreadingHTTPServer):
    service: ArtifactService
    max_body_bytes: int = 256 * 1024 * 1024
    # non-daemon handler threads: server_close() JOINS in-flight requests,
    # so the graceful drain actually finishes accepted work (a daemon
    # default would close the batcher under handlers still waiting on it)
    daemon_threads = False

    def server_close(self):
        # order matters: join handler threads FIRST (they may be waiting
        # on micro-batcher results), then stop the batcher. This also
        # closes the check-then-enqueue race in handle_predict — no
        # handler can be mid-enqueue once all handlers have been joined.
        super().server_close()
        if getattr(self, "service", None) is not None:
            self.service.close()


def make_server(artifact_dir, host: str = "127.0.0.1",
                port: int = 0, *,
                batch_window_ms: float = 0.0,
                max_body_mb: float = 256.0,
                device=None) -> ThreadingHTTPServer:
    """Load the artifact and bind the HTTP server (port 0 = ephemeral —
    the bound port is ``server.server_address[1]``). The caller runs
    ``serve_forever()`` (or a thread does; see ``main``).
    ``artifact_dir``: an artifact directory, loaded on ``device`` (None =
    the card), or a ``ServingArtifact`` already loaded.
    ``batch_window_ms``: see ArtifactService — dynamic micro-batching of
    concurrent seedless requests into full program batches."""
    from multimodal_auv_torch.serving import load_predict_artifact

    artifact = (load_predict_artifact(artifact_dir, device=device)
                if isinstance(artifact_dir, (str, os.PathLike))
                else artifact_dir)
    server = _Server((host, port), _Handler)
    server.max_body_bytes = int(max_body_mb * 1024 * 1024)
    server.service = ArtifactService(artifact,
                                     batch_window_ms=batch_window_ms)
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Serve an exported predict artifact over HTTP")
    p.add_argument("--artifact", required=True,
                   help="artifact directory (python -m "
                        "multimodal_auv_torch.cli export-serving)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--warmup", action="store_true",
                   help="run one dummy batch before accepting requests "
                        "(first-request latency -> startup latency)")
    p.add_argument("--max_body_mb", type=float, default=256.0,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="dynamic micro-batching: hold concurrent seedless "
                        "sub-batch requests up to this window and pack "
                        "them into one device call (0 = off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on: 'cuda' (the card, "
                        "default) or 'cpu'; the artifact must have been "
                        "exported on a device of that type")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    server = make_server(args.artifact, args.host, args.port,
                         batch_window_ms=args.batch_window_ms,
                         max_body_mb=args.max_body_mb, device=args.device)
    svc: ArtifactService = server.service
    if args.warmup:
        b = svc.artifact.batch_size
        n = 1 if b == "poly" else int(b)
        s = svc.artifact.image_size
        svc.predict({m: np.zeros((n, s, s, c), np.uint8)
                     for m, c in _MODALITIES}, n, seed=0)
        logger.info("warmup batch done")
    host, port = server.server_address[:2]
    logger.info("serving %s on http://%s:%d (mode=%s, batch=%s)",
                args.artifact, host, port, svc.artifact.mode,
                svc.artifact.batch_size)

    # graceful drain on preemption (same story as training's
    # engine/preemption.py): finish in-flight requests, stop the
    # micro-batcher, close the socket. shutdown() must come from another
    # thread — calling it from the handler would deadlock serve_forever.
    import signal

    def _term(signum, frame):
        logger.info("SIGTERM: draining and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
