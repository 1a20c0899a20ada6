"""The port's serving command line against the JAX package's, on the CPU.

Both CLIs serve the same synthetic detxy FITS files with the trained esr_gen
checkpoint (`docs/convergence_esr_gen/best_params.npz`, 32 filters, 4 RRDB)
through the same run config at 32^2 -> 64^2 (the JAX CLI tests' config).

Tolerances, on the products: f32 predictions within 1e-5 x hr clamp_max of
the JAX CLI's, inputs within 1e-6 x lr clamp_max; bf16 predictions within 4
bf16 ulps x hr clamp_max of the JAX CLI's `--bf16`. The checkpoint
fingerprint must equal JAX's byte for byte, so that one int8 scales file
binds in both packages.
"""

import contextlib
import io
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from test_cli import _write_run_config
from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.io.fits import read_image, write_image
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.ops import int8_forward
from xmm_superres_denoise_torch.utils import profiling as tprof
from xmm_superres_denoise_torch.utils.fingerprint import params_fingerprint
from xmm_superres_denoise_torch.utils.weights import flax_tree, load_params_npz
from xmm_superres_denoise_tpu import cli as jcli
from xmm_superres_denoise_tpu.models.registry import build_model as jax_build_model
from xmm_superres_denoise_tpu.train.checkpoints import load_params_npz as jax_load_params_npz
from xmm_superres_denoise_tpu.utils.fingerprint import params_fingerprint as jax_fingerprint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "docs/convergence_esr_gen/best_params.npz"
LR_MAX, SR_HR_MAX = 0.0022336, 0.0005584
BF16_ULPS = 4 * 2.0**-8
N_FILES = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three detxy files and the 32^2 -> 64^2 run config."""
    tmp = tmp_path_factory.mktemp("cli")
    g = np.random.default_rng(0)
    for i in range(N_FILES):
        hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0, "CRVAL1": 150.0,
               "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0}
        write_image(tmp / f"det{i}.fits", g.poisson(2.0, (28, 30)).astype(np.int32), hdr)
    return tmp, _write_run_config(tmp)


def _run(main, argv):
    """`main(argv)` in-process: (exit code, the JSON of its last stdout line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _serve(main, setup, out, *flags, device=("--device", "cpu")):
    tmp, run = setup
    return _run(main, ["serve", tmp / "det*.fits", "--checkpoint", CKPT, "--out", out,
                       "--run_config", run, "--batch", 2, *flags,
                       *(device if main is tcli.main else ())])


def _products(listing):
    return [(read_image(p["input"])[0], read_image(p["prediction"])[0]) for p in listing]


@pytest.fixture(scope="module")
def jax_products(setup):
    """The JAX CLI's serve products, f32 and bf16, computed once."""
    tmp, _ = setup
    out = {}
    for mode, flags in (("f32", ()), ("bf16", ("--bf16",))):
        rc, listing = _serve(jcli.main, setup, tmp / f"jax_{mode}", *flags)
        assert rc == 0
        out[mode] = (listing, _products(listing))
    return out


def _jax_params(run_config):
    """The Flax tree JAX's `_build_engine` hashes: model.init, then the npz."""
    ds, mc, *_ = jcli.load_run_config(run_config)
    lr = (ds.lr.res, ds.lr.res)
    hr = (ds.hr.res, ds.hr.res) if ds.hr else lr
    model = jax_build_model(mc, lr, hr)
    return jax_load_params_npz(CKPT, model.init(jax.random.PRNGKey(0), jnp.zeros((1, *lr, 1))))


@pytest.mark.parametrize("model", ["esr_gen", "rrdb_denoise"])
def test_params_fingerprint_equals_jax(setup, tmp_path, model):
    _, run = setup
    if model == "rrdb_denoise":  # a DN model takes the SR checkpoint's trunk only
        text = run.read_text().replace('name = "esr_gen"', 'name = "rrdb_denoise"')
        run = tmp_path / "dn.toml"
        run.write_text(text.replace("res = 64", "res = 32"))
    ds, mc, *_ = tcli.load_run_config(run)
    port_model = build_model(mc, (ds.lr.res,) * 2, (ds.hr.res,) * 2)
    flat = load_params_npz(CKPT, port_model)
    got = params_fingerprint({"params": flax_tree(flat)})
    want = jax_fingerprint(_jax_params(run))
    print(f"{model}: {len(flat)} arrays, port {got}, JAX {want}")
    assert got == want


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_serve_products_match_the_jax_cli(setup, jax_products, mode):
    tmp, _ = setup
    rc, listing = _serve(tcli.main, setup, tmp / f"port_{mode}",
                         *(("--bf16",) if mode == "bf16" else ()))
    assert rc == 0
    want_listing, want = jax_products[mode]
    assert [Path(p["file"]).name for p in listing] == [Path(p["file"]).name for p in want_listing]
    assert [Path(p["prediction"]).name for p in listing] == [
        Path(p["prediction"]).name for p in want_listing]
    pred_tol = (1e-5 if mode == "f32" else BF16_ULPS) * SR_HR_MAX
    for (gi, gp), (wi, wp) in zip(_products(listing), want):
        assert gp.shape == wp.shape == (64, 64) and gi.shape == wi.shape == (32, 32)
        print(f"{mode}: max|port - JAX| prediction {np.abs(gp - wp).max():.3e} "
              f"(tol {pred_tol:.3e}), input {np.abs(gi - wi).max():.3e}")
        np.testing.assert_allclose(gp, wp, rtol=0, atol=pred_tol)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6 * LR_MAX)


def test_infer_matches_the_jax_cli_and_honours_crop_p(setup, tmp_path):
    tmp, run = setup
    for crop_p, shapes in ((1.0, ((32, 32), (64, 64))), (0.5, ((16, 16), (32, 32)))):
        argv = ["infer", "--fits", tmp / "det0.fits", "--checkpoint", CKPT,
                "--run_config", run, "--crop_p", crop_p]
        rc, got = _run(tcli.main, argv + ["--out", tmp_path / f"port{crop_p}", "--device", "cpu"])
        jrc, want = _run(jcli.main, argv + ["--out", tmp_path / f"jax{crop_p}"])
        assert rc == jrc == 0 and set(got) == set(want) == {"input", "prediction"}
        for key, tol, shape in (("input", 1e-6 * LR_MAX, shapes[0]),
                                ("prediction", 1e-5 * SR_HR_MAX, shapes[1])):
            g, w = read_image(got[key])[0], read_image(want[key])[0]
            assert g.shape == w.shape == shape
            print(f"infer crop_p {crop_p} {key}: max|port - JAX| {np.abs(g - w).max():.3e}")
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.fixture
def calibrations(monkeypatch):
    """Counts the int8 engine's calls of calibrate_int8_scales."""
    calls = []
    real = int8_forward.calibrate_int8_scales

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(int8_forward, "calibrate_int8_scales", counted)
    return calls


def test_int8_scales_file_is_written_then_read_without_calibrating(setup, tmp_path, calibrations):
    scales = tmp_path / "scales.json"
    rc, first = _serve(tcli.main, setup, tmp_path / "a", "--int8", "--int8_scales", scales)
    assert rc == 0 and len(calibrations) == 1
    saved = json.loads(scales.read_text())
    assert set(saved) == {"fingerprint", "scales"}
    assert saved["fingerprint"] == jax_fingerprint(_jax_params(setup[1]))
    rc, second = _serve(tcli.main, setup, tmp_path / "b", "--int8", "--int8_scales", scales)
    assert rc == 0 and len(calibrations) == 1  # the second run loaded the file
    assert json.loads(scales.read_text()) == saved
    for (gi, gp), (wi, wp) in zip(_products(second), _products(first)):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gi, wi)


def test_int8_scales_written_by_the_jax_cli_bind_in_the_port(setup, tmp_path, calibrations):
    scales = tmp_path / "jax_scales.json"
    rc, _ = _serve(jcli.main, setup, tmp_path / "jax", "--int8", "--int8_scales", scales)
    assert rc == 0
    written = scales.read_text()
    rc, listing = _serve(tcli.main, setup, tmp_path / "port", "--int8", "--int8_scales", scales)
    assert rc == 0 and not calibrations
    assert scales.read_text() == written
    assert all(np.isfinite(p).all() for _, p in _products(listing))


def test_int8_scales_of_another_checkpoint_are_refused_and_recalibrated(
    setup, tmp_path, calibrations, caplog
):
    scales = tmp_path / "scales.json"
    _serve(tcli.main, setup, tmp_path / "a", "--int8", "--int8_scales", scales)
    good = json.loads(scales.read_text())
    scales.write_text(json.dumps({"fingerprint": "0" * 32, "scales": good["scales"]}))
    with caplog.at_level(logging.WARNING, logger="xmmsr"):
        rc, _ = _serve(tcli.main, setup, tmp_path / "b", "--int8", "--int8_scales", scales)
    assert rc == 0 and len(calibrations) == 2
    assert "DIFFERENT checkpoint" in caplog.text
    assert json.loads(scales.read_text())["fingerprint"] == good["fingerprint"]


def test_legacy_flat_int8_scales_are_used_with_a_warning(setup, tmp_path, calibrations, caplog):
    scales = tmp_path / "scales.json"
    _serve(tcli.main, setup, tmp_path / "a", "--int8", "--int8_scales", scales)
    flat = json.loads(scales.read_text())["scales"]
    scales.write_text(json.dumps(flat))
    with caplog.at_level(logging.WARNING, logger="xmmsr"):
        rc, _ = _serve(tcli.main, setup, tmp_path / "b", "--int8", "--int8_scales", scales)
    assert rc == 0 and len(calibrations) == 1
    assert "legacy format" in caplog.text
    assert json.loads(scales.read_text()) == flat  # not rewritten


def test_serve_expands_overlapping_patterns_once(setup, tmp_path):
    tmp, run = setup
    rc, listing = _run(tcli.main, [
        "serve", tmp / "det*.fits", tmp / "det0.fits", tmp / "det[01].fits",
        "--checkpoint", CKPT, "--out", tmp_path, "--run_config", run, "--device", "cpu"])
    assert rc == 0
    assert sorted(Path(p["file"]).name for p in listing) == [f"det{i}.fits" for i in range(N_FILES)]


def _orbax_dir(tmp_path):
    d = tmp_path / "orbax_ckpt"
    d.mkdir()
    return d


def _onnx(tmp_path):
    p = tmp_path / "weights.onnx"
    p.write_bytes(b"\x08\x07")
    return p


REFUSALS = {
    "unmatched-pattern": (lambda tmp, tp: [tmp / "det*.fist"], (), "no input files matched"),
    "mesh_data": (lambda tmp, tp: [tmp / "det0.fits"], ("--mesh_data", -2), "--mesh_data -2"),
    # --plot without matplotlib: refused before serving
    "plot": (lambda tmp, tp: [tmp / "det0.fits"], ("--plot", "NO_MATPLOTLIB"), "needs matplotlib"),
    # an ONNX checkpoint is read; one whose initializers do not form the model is refused
    "onnx": (lambda tmp, tp: [tmp / "det0.fits"], ("--checkpoint", "ONNX"), "ONNX import"),
    "orbax": (lambda tmp, tp: [tmp / "det0.fits"], ("--checkpoint", "ORBAX"), "needs JAX"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_requests_exit_2_before_serving(setup, tmp_path, monkeypatch, caplog, case):
    tmp, run = setup
    files, flags, message = REFUSALS[case]
    made = {"ONNX": _onnx, "ORBAX": _orbax_dir}
    if "NO_MATPLOTLIB" in flags:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        flags = [f for f in flags if f != "NO_MATPLOTLIB"]
    flags = [made[f](tmp_path) if f in made else f for f in flags]
    served = []
    monkeypatch.setattr("xmm_superres_denoise_torch.infer.run_file.serve_files",
                        lambda *a, **k: served.append(1))
    ckpt = [] if "--checkpoint" in flags else ["--checkpoint", CKPT]
    with caplog.at_level(logging.ERROR, logger="xmmsr"):
        rc, _ = _run(tcli.main, ["serve", *files(tmp, tmp_path), *ckpt, *flags,
                                 "--out", tmp_path / "out", "--run_config", run,
                                 "--device", "cpu"])
    print(caplog.text.strip())
    assert rc == 2 and not served
    assert message in caplog.text
    assert not (tmp_path / "out").exists()


def test_without_a_card_the_default_device_fails(setup, tmp_path, monkeypatch, caplog):
    tmp, run = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.ERROR, logger="xmmsr"):
        rc, _ = _run(tcli.main, ["infer", "--fits", tmp / "det0.fits", "--checkpoint", CKPT,
                                 "--out", tmp_path, "--run_config", run])
    assert rc == 2 and "no CUDA card" in caplog.text
    assert not list(tmp_path.glob("*.fits*"))


def test_engine_subcommands_accept_mesh_data():
    parser = tcli.build_parser()
    argvs = {
        "infer": ["infer", "--fits", "f", "--checkpoint", "c", "--out", "o", "--run_config", "r"],
        "serve": ["serve", "f", "--checkpoint", "c", "--out", "o", "--run_config", "r"],
        "http": ["http", "--checkpoint", "c", "--run_config", "r"],
    }
    for name, argv in argvs.items():
        args = parser.parse_args(argv + ["--mesh_data", "-1"])
        assert args.mesh_data == -1 and args.device == "cuda:0", name


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_http_serves_what_the_jax_cli_infers_and_stops_on_sigterm(setup, tmp_path):
    """The module entry point in its own process: `http` answers a POST with
    the prediction the JAX CLI's `infer` writes, and SIGTERM stops it with
    exit code 0 and its stats on the last line."""
    tmp, run = setup
    rc, want = _run(jcli.main, ["infer", "--fits", tmp / "det1.fits", "--checkpoint", CKPT,
                                "--out", tmp_path / "jax", "--run_config", run])
    assert rc == 0
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "xmm_superres_denoise_torch.cli", "http", "--port", str(port),
         "--checkpoint", str(CKPT), "--run_config", str(run), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    assert json.loads(r.read())["status"] == "ok"
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
                time.sleep(0.2)
        body = (tmp / "det1.fits").read_bytes()
        req = urllib.request.Request(url + "/infer", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = read_image(r.read())[0]
        w = read_image(want["prediction"])[0]
        print(f"http: max|port - JAX infer| {np.abs(got - w).max():.3e}")
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * SR_HR_MAX)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    stats = json.loads(out.strip().splitlines()[-1])["served"]
    assert stats["requests"] == 1 and stats["errors"] == 0


# --------------------------------------------------------------------------
# fit and test
# --------------------------------------------------------------------------


def _train_run_config(tmp, **trainer):
    """The JAX CLI tests' boring run config at 104^2 -> 208^2 (MS-SSIM, in
    the run config's loss, needs 208 px), 16 samples, image logging off."""
    text = _write_run_config(tmp).read_text()
    text = text.replace("res = 32", "res = 104").replace("res = 64", "res = 208")
    text = text.replace('name = "boring_cli"', 'name = "boring_cli"\nboring_size = 16')
    text = text.replace("log_images_every_n_epochs = 1", "log_images_every_n_epochs = 0")
    for key, value in trainer.items():  # keys the config already sets
        text = re.sub(rf"^{key} = .*$", f"{key} = {value}", text, count=1, flags=re.M)
    path = tmp / "train.toml"
    path.write_text(text)
    return path


def _small_model(load):
    """`load_run_config` with the model cut to 4 filters and 1 RRDB."""
    def wrapped(*a, **k):
        ds, mc, tc, sc, lc = load(*a, **k)
        if hasattr(mc, "model_copy"):  # the JAX package's pydantic config
            mc = mc.model_copy(update={"model": mc.model.model_copy(
                update={"filters": 4, "residual_blocks": 1})})
        else:
            mc.model.filters, mc.model.residual_blocks = 4, 1
        return ds, mc, tc, sc, lc
    return wrapped


def _run_json(main, argv):
    """`main(argv)` in-process: (exit code, its stdout parsed as one JSON object)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    return rc, (json.loads(out.getvalue()) if out.getvalue().strip() else None)


def test_fit_then_test_prints_the_jax_clis_keys(tmp_path, monkeypatch):
    run = _train_run_config(tmp_path)
    monkeypatch.setattr(tcli, "load_run_config", _small_model(tcli.load_run_config))
    monkeypatch.setattr(jcli, "load_run_config", _small_model(jcli.load_run_config))
    monkeypatch.chdir(tmp_path)  # the splits are written under ./res/splits
    rc, fit_logs = _run_json(tcli.main, ["fit", run, "--no-extended", "--device", "cpu"])
    assert rc == 0
    root = tmp_path / "ckpts/esr_gen"
    assert {"best.json", "history.jsonl", "run_config.toml", "tb", "ckpts"} <= {
        p.name for p in root.iterdir()}
    rc, test_logs = _run_json(tcli.main, ["test", run, "--no-extended", "--device", "cpu"])
    assert rc == 0 and test_logs == fit_logs  # test restores the best checkpoint fit tested
    rc, ext = _run_json(tcli.main, ["test", run, "--device", "cpu"])
    assert rc == 0 and "test/linear/vif_p" in ext and set(fit_logs) < set(ext)

    (tmp_path / "jax").mkdir()
    jrun = _train_run_config(tmp_path / "jax")
    rc, jlogs = _run_json(jcli.main, ["fit", jrun, "--no-extended"])
    print(f"port fit keys {sorted(fit_logs)}; JAX fit keys {sorted(jlogs)}")
    assert rc == 0 and sorted(fit_logs) == sorted(jlogs)


FIT_REFUSALS = {
    "tpu": ((), {"accelerator": '"tpu"'}, "CUDA card or the CPU"),
}


def test_fit_profile_traces_the_fit_and_logs_images(tmp_path, monkeypatch):
    """`fit --profile DIR` with `log_images_every_n_epochs = 1`: a Chrome
    trace of the fit's first train steps in DIR (here one), and the epoch's
    display panel and FITS."""
    pytest.importorskip("matplotlib")
    run = _train_run_config(tmp_path, log_images_every_n_epochs=1)
    monkeypatch.setattr(tcli, "load_run_config", _small_model(tcli.load_run_config))
    monkeypatch.setattr(tcli, "FIT_PROFILE_STEPS", 1)
    real_trace, fit_steps = tprof.trace, []

    @contextlib.contextmanager
    def counted_trace(*a, **k):
        with real_trace(*a, **k) as step:
            yield lambda: (fit_steps.append(1), step())

    monkeypatch.setattr(tprof, "trace", counted_trace)
    monkeypatch.chdir(tmp_path)
    rc, logs = _run_json(tcli.main, ["fit", run, "--no-extended", "--profile", tmp_path / "prof",
                                     "--device", "cpu"])
    assert rc == 0 and "test/loss" in logs
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    images = sorted(p.name for p in (tmp_path / "ckpts/esr_gen/images/epoch_00000").iterdir())
    print(f"fit --profile: {trace.name}, {trace.stat().st_size} bytes, {len(events)} events; "
          f"images {images}")
    assert any(e.get("name") == "aten::convolution" for e in events)
    steps = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("Optimizer.step#"))
    print(f"fit --profile, window of 1 train step of the fit's {len(fit_steps)}: optimizer "
          f"steps traced {steps}")
    assert len(steps) == 1 < len(fit_steps)  # the trace window, not the whole fit
    assert "display.png" in images and "display_0_generated.fits.gz" in images


@pytest.mark.parametrize("case", list(FIT_REFUSALS))
def test_fit_refusals_exit_2(tmp_path, monkeypatch, caplog, case):
    flags, trainer, message = FIT_REFUSALS[case]
    run = _train_run_config(tmp_path, **trainer)
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.ERROR, logger="xmmsr"):
        rc, _ = _run(tcli.main, ["fit", run, *flags, "--device", "cpu"])
    assert rc == 2 and message in caplog.text
    assert not (tmp_path / "ckpts/esr_gen/ckpts").exists() or not list(
        (tmp_path / "ckpts/esr_gen/ckpts").glob("*.pt"))


@pytest.mark.parametrize("cmd", ["fit", "test"])
def test_fit_and_test_without_a_card_need_device_cpu(tmp_path, monkeypatch, caplog, cmd):
    run = _train_run_config(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.ERROR, logger="xmmsr"):
        rc, _ = _run(tcli.main, [cmd, run])
    assert rc == 2 and "no CUDA card" in caplog.text
    args = tcli.build_parser().parse_args([cmd, "r.toml"])
    assert args.device == "cuda:0" and args.no_extended is False
