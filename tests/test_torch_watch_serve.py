"""The port's `watch_and_serve`: the directory-watching serving daemon, the
port of `tests/test_watch_serve.py`'s six cases on the port's engine.

Contract: only size/mtime-stable files are picked up; work identity is
(path, size, mtime); a state file makes restarts skip served history; a
corrupt input is isolated per file and recorded, never wedging the queue; a
batch too large for the device degrades to single tiles.

Engine: the trained esr_gen checkpoint (32 filters, 4 RRDB) at 32^2 -> 64^2
on the CPU, with 28 x 30 detxy images.
"""

import contextlib
import io
import json
import os
import threading
from pathlib import Path

import numpy as np

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, watch_and_serve
from xmm_superres_denoise_torch.io.fits import write_image
from xmm_superres_denoise_torch.utils.weights import params_from_flax

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "docs/convergence_esr_gen/best_params.npz"


def _engine():
    ds = tcfg.DatasetCfg(
        lr=tcfg.LrDatasetCfg(bkg=0, exps=[20], clamp_max=0.0022336, res=32),
        hr=tcfg.HrDatasetCfg(exp=100, clamp_max=0.0005584, res=64),
        scaling="sqrt", type="boring",
    )
    mc = tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"})
    return InferenceEngine(mc, ds, params_from_flax(CKPT), device="cpu")


def _drop_detxy(d: Path, name: str, seed=0) -> Path:
    g = np.random.default_rng(seed)
    hdr = {
        "EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0,
        "CRVAL1": 150.0, "CRVAL2": 2.0, "CDELT1": -0.001111,
        "CDELT2": 0.001111, "PA_PNT": 65.0,
        "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN",
    }
    return write_image(d / name, g.poisson(2.0, (28, 30)).astype(np.float32), header=hdr)


def _products(out: Path):
    return sorted(p.name for p in out.glob("*.fits*"))


def _watch(watch, engine, out, **kw):
    kw.setdefault("poll_s", 0.01)
    kw.setdefault("max_polls", 2)
    return watch_and_serve(watch, engine, out, hr_exp_ks=100.0, model_name="esr_gen", **kw)


def test_watch_serves_stable_files_and_skips_served(tmp_path):
    engine = _engine()
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    _drop_detxy(watch, "a.fits")
    # poll 1 sees a.fits for the first time (not yet stable); poll 2 serves it
    assert _watch(watch, engine, out) == 1
    assert len(_products(out)) == 2  # input and prediction products
    # a new daemon without a state file serves its history again, once
    assert _watch(watch, engine, out, state_path=None) == 1


def test_watch_state_file_survives_restart(tmp_path):
    engine = _engine()
    watch, out, state = tmp_path / "in", tmp_path / "out", tmp_path / "state.json"
    watch.mkdir()
    _drop_detxy(watch, "a.fits")

    assert _watch(watch, engine, out, state_path=state) == 1 and state.exists()
    assert list(json.loads(state.read_text()).values()) == ["ok"]
    # restart: the same file, untouched, is skipped
    assert _watch(watch, engine, out, state_path=state) == 0
    # an overwritten input is served again and the dead key pruned
    _drop_detxy(watch, "a.fits", seed=1)
    os.utime(watch / "a.fits", ns=(1, 10**15))
    assert _watch(watch, engine, out, state_path=state) == 1
    assert len(json.loads(state.read_text())) == 1
    # a deleted input's key is pruned on the next pass
    (watch / "a.fits").unlink()
    assert _watch(watch, engine, out, state_path=state) == 0
    assert json.loads(state.read_text()) == {}


def test_watch_new_arrivals_between_polls(tmp_path):
    """A file dropped after the daemon starts is served once stable. The
    daemon's waits go through a subclass of Event whose first wait drops
    the file, so no thread races the poll loop."""
    engine = _engine()
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    _drop_detxy(watch, "a.fits")

    class DropOnFirstWait(threading.Event):
        waits = 0

        def wait(self, timeout=None):
            self.waits += 1
            if self.waits == 1:
                _drop_detxy(watch, "b.fits", seed=2)
            return False

    stop = DropOnFirstWait()
    assert _watch(watch, engine, out, max_polls=4, stop=stop) == 2
    assert stop.waits >= 1
    names = _products(out)
    assert any(x.startswith("a_") for x in names) and any(x.startswith("b_") for x in names)


def test_cli_serve_watch_drain_mode(tmp_path):
    """`serve --watch --max_polls N` through the port's CLI: one
    `{"served": n}` line; the state file makes a second drain a no-op; a
    positional that is not a directory fails with exit code 2."""
    from test_cli import _write_run_config
    from xmm_superres_denoise_torch.cli import main

    watch = tmp_path / "in"
    watch.mkdir()
    _drop_detxy(watch, "det0.fits")
    run = _write_run_config(tmp_path)
    args = [
        "serve", str(watch), "--checkpoint", str(CKPT), "--out", str(tmp_path / "out"),
        "--run_config", str(run), "--batch", "2", "--device", "cpu",
        "--watch", "--poll", "0.01", "--max_polls", "3", "--state", str(tmp_path / "state.json"),
    ]
    for served in (1, 0):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(args) == 0
        assert json.loads(out.getvalue().strip().splitlines()[-1]) == {"served": served}
    assert len(sorted((tmp_path / "out").glob("*predict*.fits.gz"))) == 1

    assert main([
        "serve", str(watch / "det0.fits"), "--checkpoint", str(CKPT),
        "--out", str(tmp_path / "out2"), "--run_config", str(run), "--device", "cpu", "--watch",
    ]) == 2


def test_watch_isolates_corrupt_input(tmp_path):
    engine = _engine()
    watch, out, state = tmp_path / "in", tmp_path / "out", tmp_path / "state.json"
    watch.mkdir()
    _drop_detxy(watch, "good.fits")
    (watch / "bad.fits").write_bytes(b"NOT A FITS FILE")

    assert _watch(watch, engine, out, state_path=state) == 1  # the good file despite the bad
    served = json.loads(state.read_text())
    assert sorted("ok" if v == "ok" else v.split(":")[0] for v in served.values()) == ["error", "ok"]
    # the corrupt file is not retried
    assert _watch(watch, engine, out, state_path=state) == 0


def test_watch_oom_batch_degrades_to_single_tile(tmp_path, monkeypatch):
    """A batch-sized device out-of-memory error degrades the daemon to batch
    1: every good file still gets its products."""
    engine = _engine()
    watch, out, state = tmp_path / "in", tmp_path / "out", tmp_path / "state.json"
    watch.mkdir()
    _drop_detxy(watch, "a.fits", seed=1)
    _drop_detxy(watch, "b.fits", seed=2)
    real = engine.run_tiles

    def oom_at_big_batch(raw, batch_size=32):
        if batch_size > 1:
            raise RuntimeError(f"device out of memory serving batch_size={batch_size}")
        return real(raw, batch_size=batch_size)

    monkeypatch.setattr(engine, "run_tiles", oom_at_big_batch)
    assert _watch(watch, engine, out, batch_size=64, state_path=state) == 2
    assert sorted(json.loads(state.read_text()).values()) == ["ok", "ok"]
    names = _products(out)
    assert any("a_" in n for n in names) and any("b_" in n for n in names)
