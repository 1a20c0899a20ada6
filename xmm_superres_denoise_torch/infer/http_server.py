"""HTTP inference service over one warm InferenceEngine.

The port of the JAX package's `infer/http_server.py`, on the port's engine:
the network counterpart of `serve_files` (batch) and `watch_and_serve`
(directory daemon). A client POSTs a detxy FITS image and receives the WCS
product the file pipelines write. Standard library only (`http.server`),
threaded; one lock serialises the device work of concurrent requests. The
engine's own `torch.inference_mode` covers the handler thread's call (the
mode is thread-local, so it must be entered in that thread).

Endpoints:

* ``GET /healthz``: liveness and model identity, JSON.
* ``GET /stats``: request and error counts, latency percentiles and the
  percentiles of the wait for the engine lock (``queue_wait_ms``).
* ``POST /infer[?product=prediction|input]``: the body is one FITS image,
  plain or gzipped. The response is the gzipped FITS product (by default
  the prediction), the bytes `cli.py infer` writes, with ``X-Xmmsr-*``
  metadata headers.

Started by `cli.py http` (see `run_http_server`).
"""

from __future__ import annotations

import json
import logging
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from .run_file import InferenceEngine, load_rate_image, write_products

log = logging.getLogger("xmmsr")

# Upload bound: a full-frame float64 832^2 image is ~5.5 MB and real detxy
# uploads are under 1 MB gzipped; 256 MB turns away runaway clients.
MAX_BODY_BYTES = 256 * 1024 * 1024

# At most this many request bodies are buffered at once; further uploads get
# an immediate 503 (the engine lock serialises device work anyway).
MAX_INFLIGHT_BODIES = 4

# Per-socket-operation idle timeout: a client that stalls mid-upload frees
# its handler thread and buffer after this many seconds.
SOCKET_IDLE_TIMEOUT_S = 60.0


class BadInput(ValueError):
    """The request payload cannot be decoded or served (malformed FITS,
    wrong geometry): answered with 400, where engine failures get 500."""


class InferenceHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the warm engine and the serving state."""

    daemon_threads = True

    def __init__(
        self,
        addr: Tuple[str, int],
        engine: InferenceEngine,
        hr_exp_ks: float,
        model_name: str,
    ) -> None:
        super().__init__(addr, _Handler)
        self.engine = engine
        self.hr_exp_ks = float(hr_exp_ks)
        self.model_name = model_name
        self.engine_lock = threading.Lock()
        self.body_slots = threading.BoundedSemaphore(MAX_INFLIGHT_BODIES)
        self.stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_errors = 0
        self.latencies_ms: deque = deque(maxlen=1024)
        self.queue_waits_ms: deque = deque(maxlen=1024)

    def record(self, ok: bool, latency_ms: Optional[float] = None) -> None:
        with self.stats_lock:
            self.n_requests += 1
            if not ok:
                self.n_errors += 1
            elif latency_ms is not None:
                self.latencies_ms.append(latency_ms)

    def record_queue_wait(self, wait_ms: float) -> None:
        """The wait of a request, served or not, for the engine lock."""
        with self.stats_lock:
            self.queue_waits_ms.append(wait_ms)

    def stats(self) -> dict:
        with self.stats_lock:
            out = {
                "requests": self.n_requests,
                "errors": self.n_errors,
                "model": self.model_name,
            }
            for key, values in (("latency_ms", self.latencies_ms),
                                ("queue_wait_ms", self.queue_waits_ms)):
                if values:
                    out[key] = _percentiles(values)
            return out


def _percentiles(values) -> dict:
    v = np.asarray(values, dtype=np.float64)
    return {
        "count": int(v.size),
        "p50": round(float(np.percentile(v, 50)), 3),
        "p90": round(float(np.percentile(v, 90)), 3),
        "p99": round(float(np.percentile(v, 99)), 3),
    }


class _Handler(BaseHTTPRequestHandler):
    server: InferenceHTTPServer  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"
    # socketserver applies this as connection.settimeout(): a stalled socket
    # operation raises TimeoutError, which closes the connection
    timeout = SOCKET_IDLE_TIMEOUT_S

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        log.debug("http: " + fmt, *args)

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "model": self.server.model_name,
                "hr_exp_ks": self.server.hr_exp_ks,
            })
        elif path == "/stats":
            self._send_json(200, self.server.stats())
        else:
            self._send_json(404, {"error": f"unknown path {path!r}"})

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if url.path != "/infer":
            self._send_json(404, {"error": f"unknown path {url.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0 or length > MAX_BODY_BYTES:
            # the body is not drained (it may be huge), so the keep-alive
            # connection would read its bytes as the next request: close it
            self.close_connection = True
            self.server.record(ok=False)
            self._send_json(400, {
                "error": f"Content-Length required, 0 < n <= {MAX_BODY_BYTES}",
            })
            return
        # beyond MAX_INFLIGHT_BODIES an upload gets an immediate 503 and its
        # connection is closed; the slot is held until the request ends
        if not self.server.body_slots.acquire(blocking=False):
            self.close_connection = True
            self.server.record(ok=False)
            self._send_json(503, {
                "error": f"busy: more than {MAX_INFLIGHT_BODIES} uploads in flight",
            })
            return
        try:
            self._post_body(url, length)
        finally:
            self.server.body_slots.release()

    def _post_body(self, url, length: int) -> None:
        # drain the body before any rejection: answering while the client
        # still sends resets the connection
        body = self.rfile.read(length)

        product = parse_qs(url.query).get("product", ["prediction"])[0]
        if product not in ("prediction", "input"):
            self.server.record(ok=False)
            self._send_json(400, {
                "error": f"product must be 'prediction' or 'input', got {product!r}",
            })
            return

        t0 = time.monotonic()
        try:
            blob, meta = _serve_one(self.server, body, product)
        except BadInput as e:
            self.server.record(ok=False)
            self._send_json(400, {"error": f"cannot serve input: {e}"})
            return
        except Exception as e:  # engine, device or product failure: ours
            log.exception("http: internal error serving /infer")
            self.server.record(ok=False)
            self._send_json(500, {"error": f"internal error: {e}"})
            return
        latency_ms = (time.monotonic() - t0) * 1e3
        self.server.record(ok=True, latency_ms=latency_ms)

        self.send_response(200)
        self.send_header("Content-Type", "application/fits")
        self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(blob)))
        self.send_header("X-Xmmsr-Model", self.server.model_name)
        self.send_header("X-Xmmsr-Exposure-S", f"{meta['exposure']:.1f}")
        self.send_header("X-Xmmsr-Latency-Ms", f"{latency_ms:.1f}")
        self.end_headers()
        self.wfile.write(blob)


def _serve_one(
    server: InferenceHTTPServer, body: bytes, product: str
) -> Tuple[bytes, dict]:
    """FITS request body -> (gzipped product FITS bytes, metadata), through
    the `write_products` path the file pipelines use."""
    engine = server.engine
    try:
        rate, hdr, exposure = load_rate_image(body)
    except Exception as e:
        raise BadInput(str(e)) from e
    lr = engine.lr_res
    if rate.ndim != 2 or rate.shape[0] > lr or rate.shape[1] > lr:
        raise BadInput(
            f"image geometry {rate.shape} incompatible with the engine's "
            f"input resolution {lr} (expected the native detxy frame or "
            f"anything padding up to {lr}x{lr})"
        )
    t0 = time.monotonic()
    with server.engine_lock:  # one card: serialise device work across requests
        server.record_queue_wait((time.monotonic() - t0) * 1e3)
        pred, inp = engine(rate)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            p_in, p_pred = write_products(
                inp, pred, Path(tmp), Path("upload.fits"), exposure,
                server.hr_exp_ks, server.model_name, hdr,
            )
        except KeyError as e:  # a WCS keyword missing from the uploaded header
            raise BadInput(
                f"input header is missing required WCS keyword {e} "
                f"(detxy products need CDELT1/CDELT2 for the 2x rescale)"
            ) from e
        chosen = p_pred if product == "prediction" else p_in
        return Path(chosen).read_bytes(), {"exposure": exposure}


def run_http_server(
    host: str,
    port: int,
    engine: InferenceEngine,
    hr_exp_ks: float,
    model_name: str,
    stop: Optional[threading.Event] = None,
    on_bound: Optional[Callable[[InferenceHTTPServer], None]] = None,
) -> InferenceHTTPServer:
    """Serve until `stop` is set (or forever). Returns the server. `on_bound`
    is called with the server once it listens: its port is
    `.server_address[1]` (port 0 picks a free one)."""
    server = InferenceHTTPServer((host, port), engine, hr_exp_ks, model_name)
    log.info(
        "http: serving %s on %s:%d (POST /infer, GET /healthz, /stats)",
        model_name, *server.server_address,
    )
    if on_bound is not None:
        on_bound(server)
    if stop is None:
        server.serve_forever(poll_interval=0.2)
        return server
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.2}, daemon=True)
    thread.start()
    stop.wait()
    server.shutdown()
    thread.join(timeout=10.0)
    server.server_close()
    return server
