"""The port's HTTP inference service (`infer/http_server.py`), the port of
`tests/test_http_server.py`'s six cases on the port's engine: POST a detxy
FITS -> the WCS product bytes the file pipelines write; health and stats
endpoints; malformed inputs answered with 400, engine failures with 500,
a full server with 503, never a wedged server.

Engine: the trained esr_gen checkpoint (32 filters, 4 RRDB) at 32^2 -> 64^2
on the CPU, with 28 x 30 detxy images. The first case also holds the
response against the JAX package's `infer_file` on the same input, within
1e-5 x hr clamp_max.
"""

import gzip
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

import xmm_superres_denoise_torch.infer.http_server as hs
from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.http_server import InferenceHTTPServer
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, infer_file
from xmm_superres_denoise_torch.io.fits import read_image, write_image
from xmm_superres_denoise_torch.utils.weights import params_from_flax
from xmm_superres_denoise_tpu import config as jcfg
from xmm_superres_denoise_tpu.infer.run_file import InferenceEngine as JaxEngine
from xmm_superres_denoise_tpu.infer.run_file import infer_file as jax_infer_file

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "docs/convergence_esr_gen/best_params.npz"
SR_HR_MAX = 0.0005584
NATIVE = (28, 30)


def _dataset(mod):
    return mod.DatasetCfg(
        lr=mod.LrDatasetCfg(bkg=0, exps=[20], clamp_max=0.0022336, res=32),
        hr=mod.HrDatasetCfg(exp=100, clamp_max=SR_HR_MAX, res=64),
        scaling="sqrt", type="boring",
    )


@pytest.fixture(scope="module")
def engine():
    mc = tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"})
    return InferenceEngine(mc, _dataset(tcfg), params_from_flax(CKPT), device="cpu")


def _detxy_bytes(tmp_path, seed=0) -> bytes:
    g = np.random.default_rng(seed)
    hdr = {
        "EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0,
        "CRVAL1": 150.0, "CRVAL2": 2.0, "CDELT1": -0.001111,
        "CDELT2": 0.001111, "PA_PNT": 65.0,
        "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN",
    }
    p = write_image(tmp_path / "req.fits", g.poisson(2.0, NATIVE).astype(np.float32), header=hdr)
    return p.read_bytes()


class _Server:
    """Context manager: a live server on a free port and its base URL."""

    def __init__(self, engine):
        self.server = InferenceHTTPServer(
            ("127.0.0.1", 0), engine, hr_exp_ks=100.0, model_name="esr_gen",
        )
        self.port = self.server.server_address[1]
        self.url = "http://127.0.0.1:%d" % self.port
        self.thread = threading.Thread(
            target=self.server.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True,
        )

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(timeout=10.0)
        assert not self.thread.is_alive()
        self.server.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _http_error(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def test_http_infer_matches_file_pipeline_and_jax(engine, tmp_path):
    """POST /infer returns the products `infer_file` writes (bitwise), for
    product=prediction and product=input; the prediction is within 1e-5 x
    hr clamp_max of the JAX package's `infer_file` on the same input."""
    body = _detxy_bytes(tmp_path)
    p_in, p_pred = infer_file(tmp_path / "req.fits", engine, tmp_path / "out",
                              hr_exp_ks=100.0, model_name="esr_gen")
    with np.load(CKPT) as npz:
        tree: dict = {}
        for key in npz.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(npz[key])
    jax_model = jcfg.ModelCfg(name="esr_gen", model=jcfg.RrdbCfg(base_model="esr_gen"),
                              optimizer=jcfg.OptimizerCfg(learning_rate=1e-4))
    _, jax_pred = jax_infer_file(tmp_path / "req.fits", JaxEngine(jax_model, _dataset(jcfg), tree),
                                 tmp_path / "jax", 100.0, "esr_gen", plot=False)

    with _Server(engine) as s:
        status, headers, blob = _post(s.url + "/infer", body)
        assert status == 200
        assert headers["Content-Type"] == "application/fits"
        assert headers["X-Xmmsr-Model"] == "esr_gen"
        assert float(headers["X-Xmmsr-Exposure-S"]) == 20_000.0
        img_http = read_image(blob)[0]
        np.testing.assert_array_equal(img_http, read_image(p_pred)[0])
        assert img_http.shape == (64, 64)
        want = read_image(jax_pred)[0]
        print(f"http vs JAX infer_file: max|diff| {np.abs(img_http - want).max():.3e}")
        np.testing.assert_allclose(img_http, want, rtol=0, atol=1e-5 * SR_HR_MAX)

        status, _, blob_in = _post(s.url + "/infer?product=input", body)
        assert status == 200
        img_in = read_image(blob_in)[0]
        np.testing.assert_array_equal(img_in, read_image(p_in)[0])
        assert img_in.shape == (32, 32)


def test_http_gzipped_upload_and_stats(engine, tmp_path):
    body = gzip.compress(_detxy_bytes(tmp_path))
    with _Server(engine) as s:
        status, health = _get(s.url + "/healthz")
        assert status == 200
        assert health == {"status": "ok", "model": "esr_gen", "hr_exp_ks": 100.0}
        status, _, blob = _post(s.url + "/infer", body)
        assert status == 200 and read_image(blob)[0].shape == (64, 64)
        status, stats = _get(s.url + "/stats")
        assert status == 200
        assert stats["requests"] == 1 and stats["errors"] == 0
        assert stats["latency_ms"]["count"] == 1 and stats["latency_ms"]["p50"] > 0
        assert set(stats["latency_ms"]) == {"count", "p50", "p90", "p99"}


def test_http_stats_report_the_queue_wait(engine, tmp_path):
    with _Server(engine) as s:
        status, _, _ = _post(s.url + "/infer", _detxy_bytes(tmp_path))
        assert status == 200
        status, stats = _get(s.url + "/stats")
    assert status == 200
    assert set(stats) == {"requests", "errors", "model", "latency_ms", "queue_wait_ms"}
    wait = stats["queue_wait_ms"]
    assert set(wait) == {"count", "p50", "p90", "p99"} and wait["count"] == 1
    assert 0 <= wait["p50"] <= stats["latency_ms"]["p50"]


def test_http_queue_wait_times_the_engine_lock(engine, tmp_path):
    """A request that finds the engine busy waits for its lock, and
    `queue_wait_ms` holds that wait, which `latency_ms` includes."""
    body = _detxy_bytes(tmp_path)
    busy, waiting = threading.Lock(), threading.Event()

    class Lock:  # the engine's lock, held by the test until a request waits on it
        def __enter__(self):
            waiting.set()
            busy.acquire()

        def __exit__(self, *exc):
            busy.release()

    with _Server(engine) as s:
        s.server.engine_lock = Lock()
        done = []
        busy.acquire()
        client = threading.Thread(target=lambda: done.append(_post(s.url + "/infer", body)))
        client.start()
        assert waiting.wait(timeout=60)
        time.sleep(0.3)
        busy.release()
        client.join(timeout=120)
        status, stats = _get(s.url + "/stats")
    assert done[0][0] == 200
    assert stats["queue_wait_ms"]["count"] == 1
    assert 300 <= stats["queue_wait_ms"]["p50"] <= stats["latency_ms"]["p50"]


def test_http_error_paths(engine, tmp_path):
    """Malformed bodies, bad parameters and unknown paths answer 4xx JSON and
    the server keeps serving afterwards."""
    good = _detxy_bytes(tmp_path)
    with _Server(engine) as s:
        code, err = _http_error(s.url + "/infer", b"NOT A FITS FILE")
        assert code == 400 and "error" in err
        code, err = _http_error(s.url + "/infer?product=both", good)
        assert code == 400 and "product" in err["error"]
        code, _ = _http_error(s.url + "/nope")
        assert code == 404
        code, _ = _http_error(s.url + "/infer", b"")
        assert code == 400  # an empty body is refused up front
        big = write_image(tmp_path / "big.fits", np.zeros((40, 40), np.float32),
                          header={"EXPOSURE": 20_000.0})
        code, err = _http_error(s.url + "/infer", big.read_bytes())
        assert code == 400 and "geometry" in err["error"]
        nowcs = write_image(tmp_path / "nowcs.fits", np.zeros(NATIVE, np.float32),
                            header={"EXPOSURE": 20_000.0})
        code, err = _http_error(s.url + "/infer", nowcs.read_bytes())
        assert code == 400 and "WCS keyword" in err["error"]

        status, _, blob = _post(s.url + "/infer", good)
        assert status == 200 and read_image(blob)[0].shape == (64, 64)
        _, stats = _get(s.url + "/stats")
        assert stats["errors"] == 5  # the 404 is not an /infer error
        assert stats["requests"] == 6


def test_http_busy_backpressure_and_idle_timeout(engine, tmp_path):
    """With every body slot taken, an upload gets 503 at once instead of
    being buffered; handler sockets carry an idle timeout. The request is
    sent as headers alone over a raw socket and the 503 read before the
    socket closes, so no body is in flight when the server answers (a body
    still being sent would meet a reset instead of the 503)."""
    assert hs._Handler.timeout == hs.SOCKET_IDLE_TIMEOUT_S > 0
    good = _detxy_bytes(tmp_path)
    with _Server(engine) as s:
        for _ in range(hs.MAX_INFLIGHT_BODIES):
            assert s.server.body_slots.acquire(blocking=False)
        try:
            with socket.create_connection(("127.0.0.1", s.port), timeout=30) as sock:
                sock.sendall(
                    f"POST /infer HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                    f"Content-Length: {len(good)}\r\n\r\n".encode()
                )
                reply = b""
                while chunk := sock.recv(65536):
                    reply += chunk
            head, _, payload = reply.partition(b"\r\n\r\n")
            assert head.split(b"\r\n")[0].split()[1] == b"503"
            assert "busy" in json.loads(payload)["error"]
        finally:
            for _ in range(hs.MAX_INFLIGHT_BODIES):
                s.server.body_slots.release()
        status, _, blob = _post(s.url + "/infer", good)
        assert status == 200 and read_image(blob)[0].shape == (64, 64)


def test_http_engine_failure_is_500_and_server_survives(engine, tmp_path, monkeypatch):
    good = _detxy_bytes(tmp_path)
    real_call = type(engine).__call__
    broken = {"on": True}

    def flaky(self, rate):
        if broken["on"]:
            raise RuntimeError("injected device loss")
        return real_call(self, rate)

    monkeypatch.setattr(type(engine), "__call__", flaky)
    with _Server(engine) as s:
        code, err = _http_error(s.url + "/infer", good)
        assert code == 500 and "internal error" in err["error"]
        broken["on"] = False
        status, _, blob = _post(s.url + "/infer", good)
        assert status == 200 and read_image(blob)[0].shape == (64, 64)


def test_http_oversized_body_rejected_and_connection_closed(engine, tmp_path, monkeypatch):
    """A Content-Length over the cap answers 400 without reading the body and
    closes the connection; the server stays healthy. As above, the request
    goes as headers alone, so the 400 always arrives."""
    monkeypatch.setattr(hs, "MAX_BODY_BYTES", 1024)
    good = _detxy_bytes(tmp_path)
    assert len(good) > 1024
    with _Server(engine) as s:
        with socket.create_connection(("127.0.0.1", s.port), timeout=30) as sock:
            sock.sendall(f"POST /infer HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                         f"Content-Length: {len(good)}\r\n\r\n".encode())
            reply = b""
            while chunk := sock.recv(65536):  # ends: the server closes the connection
                reply += chunk
        assert reply.split(b"\r\n")[0].split()[1] == b"400"
        monkeypatch.setattr(hs, "MAX_BODY_BYTES", 256 * 1024 * 1024)
        status, _, blob = _post(s.url + "/infer", good)
        assert status == 200 and read_image(blob)[0].shape == (64, 64)
