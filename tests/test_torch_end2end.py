"""The port's obsid chain (`infer/end2end.py`, `cli detxy` / `end2end`)
against the JAX package's, on the CPU.

A synthetic PPS directory made from a seed with the port's bintable writer:
an EPN imaging event list (IEVLI) at mission times with X/Y sky columns and
the REFX/REFY sky-frame keywords but no *_PNT pointing keywords, a flaring
background curve (FBKTSR) with flares, a calibration index (CALIND) and an
attitude timeseries (ATTTSR) from which the pointing is recovered.

* `detxy_for_obsid`: the detxy FITS and the radec FITS are byte-identical
  to the JAX package's;
* `run_end2end` with the same weights (the esr_gen SR model cut to 4
  filters and one RRDB, at the engine's fixed 416^2 -> 832^2, as the JAX
  package's `tests/test_inference.py` builds it): the detxy product is
  byte-identical, the prediction within 1e-5 x hr clamp_max (the f32 parity
  class, 1e-5 on [0, 1]) of JAX's and the padded input within 1e-6 x lr
  clamp_max; no PNG without `plot` (`tests/test_torch_plots.py` draws them);
* the CLI's `detxy` and `end2end --device cpu`: the same JSON keys as the
  JAX CLI's and the same products (the end2end prediction at the f32
  class); `end2end` without `--device cpu` exits 2 when no card is visible.
"""

import contextlib
import functools
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from test_cli import _write_run_config
from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.infer import end2end as te2e
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.io.fits import read_image, write_bintable
from xmm_superres_denoise_torch.utils.weights import params_from_flax
from xmm_superres_denoise_tpu import cli as jcli
from xmm_superres_denoise_tpu.infer import end2end as je2e
from xmm_superres_denoise_tpu.infer.run_file import InferenceEngine as JaxEngine
from xmm_superres_denoise_tpu.models.registry import build_model as jax_build_model
from xmm_superres_denoise_tpu.train.checkpoints import save_params_npz as jax_save_params_npz

ROOT = Path(__file__).resolve().parents[1]
LR_MAX, SR_HR_MAX = 0.0022336, 0.0005584
X0, X1, Y0, Y1 = -16120, 16119, -16440, 16439  # EPN at bin 80: 403 x 411
MISSION_T0 = 5.6e8


def write_pps(pps: Path, n: int = 20_000, seed: int = 3) -> Path:
    """A synthetic PPS directory (EVLI, FBKTSR, CALIND, ATTTSR)."""
    pps.mkdir(parents=True, exist_ok=True)
    g = np.random.default_rng(seed)
    write_bintable(
        pps / "P0123456789PNS003PIEVLI0000.FTZ",
        {
            "TIME": np.sort(g.uniform(MISSION_T0, MISSION_T0 + 30_000, n)),
            "DETX": g.integers(X0, X1 + 1, n).astype(np.int32),
            "DETY": g.integers(Y0, Y1 + 1, n).astype(np.int32),
            "X": g.integers(20_000, 32_000, n).astype(np.int32),
            "Y": g.integers(20_000, 32_000, n).astype(np.int32),
            "PI": g.integers(150, 12_000, n).astype(np.int32),
            "PATTERN": g.integers(0, 13, n).astype(np.int32),
            "FLAG": g.choice(np.array([0, 0, 0, 1, 0x10], np.int32), n),
        },
        extname="EVENTS",
        header={"INSTRUME": "EPN", "ONTIME": 30_000.0, "TSTART": MISSION_T0,
                "TSTOP": MISSION_T0 + 30_000.0, "OBS_ID": "0123456789",
                "REFXCRPX": 25921, "REFYCRPX": 25921, "REFXCRVL": 187.701875,
                "REFYCRVL": 12.389, "REFXCDLT": -1.38888888888889e-05,
                "REFYCDLT": 1.38888888888889e-05},
        column_limits={"DETX": (X0, X1), "DETY": (Y0, Y1), "X": (1, 51840), "Y": (1, 51840)},
    )
    t = MISSION_T0 + np.arange(0, 30_000, 100.0)
    rate = np.full_like(t, 0.2)
    rate[(t >= MISSION_T0 + 10_000) & (t < MISSION_T0 + 12_000)] = 9.0
    rate[::23] = 4.0  # short flares: more GTIs
    write_bintable(pps / "P0123456789PNS003FBKTSR0000.FTZ", {"TIME": t, "RATE": rate},
                   extname="RATE", header={"FLCUTTHR": 0.5},
                   primary_header={"INSTRUME": "EPN", "OBS_ID": "0123456789"})
    (pps / "P0123456789OBX000CALIND0000.FTZ").write_bytes(b"\x00")
    ta = MISSION_T0 + np.linspace(0, 30_000, 300)
    write_bintable(pps / "P0123456789OBX000ATTTSR0000.FTZ",
                   {"TIME": ta, "AHFRA": 187.7 + g.normal(0, 1e-3, 300),
                    "AHFDEC": 12.39 + g.normal(0, 1e-3, 300),
                    "AHFPA": 109.3 + g.normal(0, 1e-2, 300)}, extname="ATTHK")
    return pps


def tiny_setup(tmp: Path):
    """A resource directory whose esr_gen has 4 filters and one RRDB, the
    416^2 -> 832^2 run config on it, and a JAX-initialised npz of that model.
    Returns (run config, res dir, npz)."""
    res = tmp / "res"
    (res / "configs").mkdir(parents=True)
    shutil.copy(ROOT / "res/configs/loss_functions.toml", res / "configs")
    (res / "configs/models.toml").write_text(
        '[esr_gen]\nbase_model = "esr_gen"\nin_channels = 1\nout_channels = 1\n'
        "filters = 4\nresidual_blocks = 1\nlearning_rate = 0.0001\nbetas = [0.9, 0.999]\n")
    run = _write_run_config(tmp)
    run.write_text(run.read_text().replace("res = 32", "res = 416").replace("res = 64", "res = 832"))
    ds, mc, *_ = jcli.load_run_config(run, res_dir=res)
    model = jax_build_model(mc, (416, 416), (832, 832))
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(1), jnp.zeros((1, 416, 416, 1))))
    # lift the output off the clamp at 0, which every pixel of this random
    # 4-filter model falls under: the products then hold the model's output
    params["params"]["conv_last"]["bias"] = params["params"]["conv_last"]["bias"] + 0.5
    npz = tmp / "tiny.npz"
    jax_save_params_npz(npz, params)
    return run, res, npz


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    run, res, npz = tiny_setup(tmp)
    return tmp, write_pps(tmp / "pps"), run, res, npz


@pytest.fixture
def tiny_cli(setup, monkeypatch):
    """Both CLIs read the tiny resource directory."""
    _, _, _, res, _ = setup
    monkeypatch.setattr(tcli, "load_run_config",
                        functools.partial(tcli.load_run_config, res_dir=res))
    monkeypatch.setattr(jcli, "load_run_config",
                        functools.partial(jcli.load_run_config, res_dir=res))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def test_detxy_for_obsid_byte_identical_to_jax(setup):
    tmp, pps, *_ = setup
    pt = te2e.detxy_for_obsid(pps, tmp / "detxy_port")
    pj = je2e.detxy_for_obsid(pps, tmp / "detxy_jax")
    assert pt.name == pj.name == "pn_500_2000_detxy_image_20ks.fits"
    for name in (pt.name, "pn_500_2000_radec_image_20ks.fits"):
        a, b = (tmp / "detxy_port" / name).read_bytes(), (tmp / "detxy_jax" / name).read_bytes()
        print(f"{name}: {len(a)} bytes, identical {a == b}")
        assert a == b
    img, hdr = read_image(pt)
    assert img.shape == (411, 403) and img.sum() > 0
    # the pointing came from the ATTTSR median: absolute sky WCS, SAS-free
    assert abs(hdr["RA_PNT"] - 187.7) < 1e-3 and "CD1_1" in hdr and "CRVAL1" in hdr
    # the capped exposure may overshoot 20 ks: the reference's quirk, kept
    assert hdr["EXPOSURE"] > 0


def _engines(run, res, npz):
    from xmm_superres_denoise_torch.models.registry import build_model
    from xmm_superres_denoise_torch.utils.weights import load_params_npz
    from xmm_superres_denoise_tpu.train.checkpoints import load_params_npz as jax_load

    ds_t, mc_t, *_ = tcli.load_run_config(run, res_dir=res)
    ds_j, mc_j, *_ = jcli.load_run_config(run, res_dir=res)
    model = build_model(mc_t, (416, 416), (832, 832))
    port = InferenceEngine(mc_t, ds_t, params_from_flax(load_params_npz(npz, model), model),
                           device="cpu")
    jmodel = jax_build_model(mc_j, (416, 416), (832, 832))
    jparams = jax_load(npz, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 416, 416, 1))))
    return port, JaxEngine(mc_j, ds_j, jparams)


def test_run_end2end_matches_jax(setup):
    tmp, pps, run, res, npz = setup
    port, jax_engine = _engines(run, res, npz)
    rt = te2e.run_end2end(pps, port, tmp / "run_port", hr_exp_ks=100.0, model_name="esr_gen")
    rj = je2e.run_end2end(pps, jax_engine, tmp / "run_jax", hr_exp_ks=100.0,
                          model_name="esr_gen", plot=False)
    assert sorted(rt) == sorted(rj) == ["detxy", "input", "latency_s", "prediction"]
    assert sorted(rt["latency_s"]) == ["binning", "inference", "total"]
    assert Path(rt["detxy"]).read_bytes() == Path(rj["detxy"]).read_bytes()
    (pt, ht), (pj, hj) = read_image(rt["prediction"]), read_image(rj["prediction"])
    (it, _), (ij, _) = read_image(rt["input"]), read_image(rj["input"])
    assert pt.shape == (832, 832) and it.shape == (416, 416)
    assert pt.std() > 0, "the tiny model clamps every output: a vacuous comparison"
    err, err_in = np.abs(pt - pj).max(), np.abs(it - ij).max()
    print(f"run_end2end: max|port - JAX| prediction {err:.3e} = {err / SR_HR_MAX:.3e} x "
          f"hr_max (tol 1e-5), input {err_in:.3e} (tol {1e-6 * LR_MAX:.3e})")
    assert err <= 1e-5 * SR_HR_MAX and err_in <= 1e-6 * LR_MAX
    assert dict(ht) == dict(hj)
    assert not list((tmp / "run_port").glob("*.png"))


def test_cli_detxy_matches_the_jax_cli(setup):
    tmp, pps, *_ = setup
    rc_t, out_t = _run(tcli.main, ["detxy", "--pps", pps, "--out", tmp / "cli_detxy_port"])
    rc_j, out_j = _run(jcli.main, ["detxy", "--pps", pps, "--out", tmp / "cli_detxy_jax"])
    assert rc_t == rc_j == 0 and sorted(out_t) == sorted(out_j) == ["detxy"]
    assert Path(out_t["detxy"]).read_bytes() == Path(out_j["detxy"]).read_bytes()


def test_cli_end2end_matches_the_jax_cli(setup, tiny_cli):
    tmp, pps, run, _, npz = setup
    common = ["--pps", pps, "--checkpoint", npz, "--run_config", run, "--max_expo", 20]
    rc_t, out_t = _run(tcli.main, ["end2end", *common, "--out", tmp / "cli_port",
                                   "--device", "cpu"])
    rc_j, out_j = _run(jcli.main, ["end2end", *common, "--out", tmp / "cli_jax"])
    assert rc_t == rc_j == 0
    assert sorted(out_t) == sorted(out_j) == ["detxy", "input", "latency_s", "prediction"]
    assert Path(out_t["detxy"]).read_bytes() == Path(out_j["detxy"]).read_bytes()
    for k in ("input", "prediction"):
        assert Path(out_t[k]).name == Path(out_j[k]).name
    pt, pj = read_image(out_t["prediction"])[0], read_image(out_j["prediction"])[0]
    err = np.abs(pt - pj).max()
    print(f"cli end2end: max|port - JAX| prediction {err / SR_HR_MAX:.3e} x hr_max (tol 1e-5)")
    assert err <= 1e-5 * SR_HR_MAX
    assert "'binning'" in out_t["latency_s"] and "'total'" in out_t["latency_s"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cli_end2end_needs_a_card_unless_cpu(setup, tiny_cli, monkeypatch):
    tmp, pps, run, _, npz = setup
    rc, out = _run(tcli.main, ["end2end", "--pps", pps, "--checkpoint", npz, "--run_config",
                               run, "--out", tmp / "no_card"])
    assert rc == 2 and out is None
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # --plot without matplotlib
    rc, out = _run(tcli.main, ["end2end", "--pps", pps, "--checkpoint", npz, "--run_config",
                               run, "--out", tmp / "plot", "--device", "cpu", "--plot"])
    assert rc == 2 and out is None and not (tmp / "plot").exists()
