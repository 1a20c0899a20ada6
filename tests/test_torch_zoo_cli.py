"""The port's command line with a transformer-zoo run config, on the CPU.

* `infer` of `res/configs/runs/swinir_sr.toml` (416^2 -> 832^2, window 13)
  with a JAX-initialised npz against the JAX CLI's `infer`, the model cut
  down as `test_torch_cli.py` cuts esr_gen (embed 12, one RSTB of depth 2:
  a full-width forward takes minutes on a CPU): the prediction within 1e-5
  x hr clamp_max, the input within 1e-6 x lr clamp_max, the checkpoint's
  fingerprint equal to JAX's; `serve --bf16` within 4 bf16 ulps x hr
  clamp_max of the JAX CLI's `serve --bf16`.
* `fit` then `test` of the same cut SwinIR on the JAX CLI tests' boring
  dataset (104^2 -> 208^2, one epoch): finite losses, the files a fit
  leaves, `test` equal to fit's test.
* A SwinIR serves on a data mesh of replicas as on one device.
"""

import importlib
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_zoo_common import jax_init
from test_torch_cli import _run, _run_json, _train_run_config

from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.io.fits import read_image, write_image
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.utils.fingerprint import params_fingerprint
from xmm_superres_denoise_torch.utils.weights import flax_tree, load_params_npz

jcli = importlib.import_module("xmm_superres_denoise_tpu.cli")
jck = importlib.import_module("xmm_superres_denoise_tpu.train.checkpoints")
jregistry = importlib.import_module("xmm_superres_denoise_tpu.models.registry")
jfingerprint = importlib.import_module("xmm_superres_denoise_tpu.utils.fingerprint")

ROOT = Path(__file__).resolve().parents[1]
RUN = ROOT / "res/configs/runs/swinir_sr.toml"
LR_MAX, HR_MAX = 0.0022336, 0.0005584
BF16_ULPS = 4 * 2.0**-8
CUT = {"embed_dim": 12, "depths": [2], "num_heads": [2]}


def _cut(load):
    """`load_run_config` with the SwinIR cut to embed 12 and one RSTB of depth 2."""
    def wrapped(*a, **k):
        ds, mc, tc, sc, lc = load(*a, **k)
        if hasattr(mc, "model_copy"):  # the JAX package's pydantic config
            mc = mc.model_copy(update={"model": mc.model.model_copy(update=CUT)})
        else:
            for key, value in CUT.items():
                setattr(mc.model, key, value)
        return ds, mc, tc, sc, lc
    return wrapped


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two detxy files and a JAX-initialised npz of the cut SwinIR."""
    tmp = tmp_path_factory.mktemp("zoo_cli")
    g = np.random.default_rng(0)
    for i in range(2):
        hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 200.0, "CRPIX2": 205.0, "CRVAL1": 150.0 + i,
               "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0}
        write_image(tmp / f"det{i}.fits", g.poisson(2.0, (411, 403)).astype(np.int32), hdr)
    ds, mc, *_ = _cut(jcli.load_run_config)(RUN)
    model = jregistry.build_model(mc, (416, 416), (832, 832))
    params = jax_init(model, np.zeros((1, 26, 26, 1), np.float32), seed=3)
    jck.save_params_npz(tmp / "swinir.npz", params)
    return tmp


@pytest.fixture
def cut(monkeypatch):
    monkeypatch.setattr(tcli, "load_run_config", _cut(tcli.load_run_config))
    monkeypatch.setattr(jcli, "load_run_config", _cut(jcli.load_run_config))


def test_infer_and_serve_bf16_match_the_jax_cli(setup, cut, tmp_path):
    fits, ckpt = setup / "det0.fits", setup / "swinir.npz"
    args = ["--checkpoint", ckpt, "--run_config", RUN]
    rc, want = _run(jcli.main, ["infer", "--fits", fits, "--out", tmp_path / "jax", *args])
    assert rc == 0
    rc, got = _run(tcli.main, ["infer", "--fits", fits, "--out", tmp_path / "port", *args,
                               "--device", "cpu"])
    assert rc == 0
    for key, tol in (("prediction", 1e-5 * HR_MAX), ("input", 1e-6 * LR_MAX)):
        g, w = read_image(got[key])[0], read_image(want[key])[0]
        assert g.shape == w.shape == ((832, 832) if key == "prediction" else (416, 416))
        print(f"infer {key}: max|port - JAX CLI| {np.abs(g - w).max():.3e} (tol {tol:.1e})")
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)

    ds, mc, *_ = tcli.load_run_config(RUN)
    flat = load_params_npz(ckpt, build_model(mc, (416, 416), (832, 832)))
    jds, jmc, *_ = jcli.load_run_config(RUN)
    jparams = jck.load_params_npz(ckpt, jregistry.build_model(jmc, (416, 416), (832, 832)).init(
        jax.random.PRNGKey(0), np.zeros((1, 26, 26, 1), np.float32)))
    assert params_fingerprint({"params": flax_tree(flat)}) == jfingerprint.params_fingerprint(
        jparams)

    served = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        device = ["--device", "cpu"] if main is tcli.main else []
        rc, listing = _run(main, ["serve", setup / "det*.fits", "--out", tmp_path / f"{name}16",
                                  *args, "--bf16", "--batch", 2, *device])
        assert rc == 0
        served[name] = np.stack([read_image(p["prediction"])[0] for p in listing])
    err = float(np.abs(served["port"] - served["jax"]).max())
    print(f"serve --bf16 (2 files): max|port - JAX CLI| {err / HR_MAX:.3e} x hr_max "
          f"(tol {BF16_ULPS})")
    assert err <= BF16_ULPS * HR_MAX


def test_fit_then_test_a_cut_swinir(tmp_path, cut, monkeypatch):
    run = _train_run_config(tmp_path, epochs=1)
    run.write_text(run.read_text().replace('name = "esr_gen"', 'name = "swinir"'))
    monkeypatch.chdir(tmp_path)  # the splits are written under ./res/splits
    rc, fit_logs = _run_json(tcli.main, ["fit", run, "--no-extended", "--device", "cpu"])
    assert rc == 0
    root = tmp_path / "ckpts/swinir"
    history = [json.loads(line) for line in (root / "history.jsonl").read_text().splitlines()]
    assert len(history) == 1 and sorted(p.name for p in (root / "ckpts").glob("*.pt")) == ["1.pt"]
    assert all(math.isfinite(history[0][k]) for k in ("train/loss", "val/loss"))
    assert all(v is not None and math.isfinite(v) for v in fit_logs.values())
    rc, test_logs = _run_json(tcli.main, ["test", run, "--no-extended", "--device", "cpu"])
    print(f"cut SwinIR fit: train/loss {history[0]['train/loss']:.6f}, val/loss "
          f"{history[0]['val/loss']:.6f}, test/loss {fit_logs['test/loss']:.6f}; "
          f"test equal to fit's: {test_logs == fit_logs}")
    assert rc == 0 and test_logs == fit_logs


def test_a_zoo_model_serves_on_a_mesh_as_on_one_device():
    """A SwinIR (embed 12, window 8, at 24^2 -> 48^2) through the engine on
    a mesh of two replicas on the host, batches of 1 and 3 (padded to 4 and
    trimmed): the predictions within rtol 1e-6 / atol 1e-7 of one device's
    (the bound of tests/test_torch_mesh_serving.py); each replica holds its
    own copy of the transformer."""
    mc = tcfg.ModelCfg(name="swinir", model=dict(
        base_model="swinir", img_size=24, patch_size=8, window_size=8, embed_dim=12,
        num_heads=[2], depths=[1]))
    ds = tcfg.DatasetCfg(lr=dict(exps=[20], clamp_max=LR_MAX, res=24),
                         hr=dict(exp=100, clamp_max=HR_MAX, res=48), scaling="sqrt")
    model = build_model(mc, (24, 24), (48, 48))
    model.reset_parameters(torch.Generator().manual_seed(2))
    state = model.state_dict()
    one = InferenceEngine(mc, ds, state, device="cpu")
    mesh = InferenceEngine(mc, ds, state, mesh=("cpu", "cpu"))
    assert mesh._replicas[0].model is not mesh._replicas[1].model
    for b in (1, 3):
        raw = np.random.default_rng(b).uniform(0, 2e-3, (b, 22, 20)).astype(np.float32)
        (p1, i1), (pm, im) = one(raw), mesh(raw)
        print(f"swinir on a mesh of 2, batch {b}: max|mesh - one device| "
              f"{np.abs(pm - p1).max():.3e} (rtol 1e-6, atol 1e-7)")
        assert pm.shape == (b, 48, 48) and np.abs(pm).max() > 0
        np.testing.assert_allclose(pm, p1, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(im, i1)
