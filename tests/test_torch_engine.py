"""The port's serving engine against the JAX package's, on the CPU: the same
synthetic detxy FITS through both `InferenceEngine`s at lr.res = 64 with the
trained esr_gen weights, products compared.

Tolerance: predictions to 1e-5 x hr clamp_max (the products' full scale),
far below the 1e-3 bar; the denormalized inputs to 1e-6 x lr clamp_max.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.run_file import (
    InferenceEngine,
    infer_file,
    serve_files,
)
from xmm_superres_denoise_torch.io.fits import write_image
from xmm_superres_denoise_torch.utils.weights import params_from_flax
from xmm_superres_denoise_tpu import config as jcfg
from xmm_superres_denoise_tpu.cli import load_run_config as jax_load_run_config
from xmm_superres_denoise_tpu.infer.run_file import InferenceEngine as JaxEngine
from xmm_superres_denoise_tpu.infer.run_file import infer_file as jax_infer_file
from xmm_superres_denoise_tpu.io.fits import read_image

ROOT = Path(__file__).resolve().parents[1]
PARAMS = ROOT / "docs/convergence_esr_gen/best_params.npz"
LR_MAX, SR_HR_MAX = 0.0022336, 0.0005584
RES = 64
NATIVE = (60, 57)


@pytest.fixture(scope="module")
def flat():
    with np.load(PARAMS) as npz:
        return {k: npz[k] for k in npz.files}


def _tree(flat, sr):
    tree: dict = {}
    for key, value in flat.items():
        if not sr and key.startswith(("params/upconv", "params/HRconv")):
            continue
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _dataset(mod, sr):
    hr_max = SR_HR_MAX if sr else LR_MAX
    return mod.DatasetCfg(
        lr=mod.LrDatasetCfg(bkg=0, exps=[20], clamp_max=LR_MAX, res=RES),
        hr=mod.HrDatasetCfg(exp=100 if sr else 50, clamp_max=hr_max,
                            res=2 * RES if sr else RES),
        scaling="sqrt", type="boring",
    )


def _port_engine(flat, sr=True, **kw):
    name = "esr_gen" if sr else "rrdb_denoise"
    return InferenceEngine(
        tcfg.ModelCfg(name=name, model={"base_model": name}), _dataset(tcfg, sr),
        params_from_flax(_tree(flat, sr)), device="cpu", **kw,
    )


def _engines(flat, sr=True, **kw):
    name = "esr_gen" if sr else "rrdb_denoise"
    jax_model = jcfg.ModelCfg(
        name=name, model=jcfg.RrdbCfg(base_model=name),
        optimizer=jcfg.OptimizerCfg(learning_rate=1e-4),
    )
    jax_engine = JaxEngine(jax_model, _dataset(jcfg, sr), _tree(flat, sr), **kw)
    return jax_engine, _port_engine(flat, sr, **kw)


def _write_detxy(path, seed=0, shape=NATIVE):
    g = np.random.default_rng(seed)
    hdr = {
        "EXPOSURE": 20_000.0, "CRPIX1": 30.0, "CRPIX2": 28.0, "CRVAL1": 150.0,
        "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0,
        "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "OBJECT": "synthetic",
    }
    return write_image(path, g.poisson(2.0, shape).astype(np.int32), hdr)


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "dn"])
def test_infer_file_products_match_jax(flat, tmp_path, sr):
    src = _write_detxy(tmp_path / "pn_detxy_image_20ks.fits")
    jax_engine, port_engine = _engines(flat, sr)
    name = "esr_gen" if sr else "rrdb_denoise"
    want = jax_infer_file(src, jax_engine, tmp_path / "jax", 100.0, name, plot=False)
    got = infer_file(src, port_engine, tmp_path / "port", 100.0, name)
    assert [p.name for p in got] == [p.name for p in want]
    hr_max = SR_HR_MAX if sr else LR_MAX
    pred_res = 2 * RES if sr else RES
    checks = ((1e-6 * LR_MAX, (RES, RES)), (1e-5 * hr_max, (pred_res, pred_res)))
    for g, w, (scale, shape) in zip(got, want, checks):
        gi, gh = read_image(g)
        wi, wh = read_image(w)
        assert gi.shape == wi.shape == shape
        print(f"{g.name}: max|port - jax| {np.abs(gi - wi).max():.3e} (atol {scale:.3e})")
        np.testing.assert_allclose(gi, wi, rtol=0, atol=scale)
        assert list(gh) == list(wh)
        assert {k: gh[k] for k in gh} == {k: wh[k] for k in wh}


def test_mask_and_crop_match_jax(flat):
    g = np.random.default_rng(5)
    mask = (g.uniform(size=NATIVE) > 0.1).astype(np.float32)
    raw = g.uniform(0, 2e-3, (2, *NATIVE)).astype(np.float32)
    jax_engine, port_engine = _engines(flat, det_mask=mask, crop_p=0.75)
    want_pred, want_inp = jax_engine(raw)
    got_pred, got_inp = port_engine(raw)
    assert got_pred.shape == (2, 96, 96) and got_inp.shape == (2, 48, 48)
    print(f"mask+crop: max|port - jax| pred {np.abs(got_pred - want_pred).max():.3e}, "
          f"input {np.abs(got_inp - want_inp).max():.3e}")
    np.testing.assert_allclose(got_inp, want_inp, rtol=0, atol=1e-6 * LR_MAX)
    np.testing.assert_allclose(got_pred, want_pred, rtol=0, atol=1e-5 * SR_HR_MAX)


def test_serve_files_matches_infer_file_with_distinct_stems(flat, tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    files = [
        _write_detxy(tmp_path / "a" / "img.fits", seed=1),
        _write_detxy(tmp_path / "b" / "img.fits", seed=2),
        _write_detxy(tmp_path / "c.fits", seed=3),
    ]
    engine = _port_engine(flat)
    served = serve_files(files, engine, tmp_path / "out", 100.0, "esr_gen", batch_size=2)
    names = [p.name for pair in served for p in pair]
    assert len(set(names)) == 6 and "img__2_predict_wcs.fits.gz" in names
    for f, (_, pred) in zip(files, served):
        single = infer_file(f, engine, tmp_path / "single" / f.parent.name, 100.0, "esr_gen")
        # batch 2 vs batch 1: the CPU convolutions sum in another order
        np.testing.assert_allclose(
            read_image(pred)[0], read_image(single[1])[0], rtol=0, atol=1e-5 * SR_HR_MAX
        )


def test_tiles_chunking_matches_one_call(flat):
    engine = _port_engine(flat)
    raw = np.random.default_rng(6).uniform(0, 2e-3, (5, *NATIVE)).astype(np.float32)
    pred, inp = engine(raw)
    tiles_pred, tiles_inp = engine.run_tiles(raw, batch_size=2)
    np.testing.assert_allclose(tiles_pred, pred, rtol=0, atol=1e-5 * SR_HR_MAX)
    np.testing.assert_array_equal(tiles_inp, inp)
    np.testing.assert_array_equal(engine.predict_tiles(raw, batch_size=2), tiles_pred)


def test_out_of_memory_halves_the_batch(flat, monkeypatch):
    engine = _port_engine(flat)
    raw = np.random.default_rng(7).uniform(0, 2e-3, (3, *NATIVE)).astype(np.float32)
    want = engine.predict_tiles(raw, batch_size=1)
    real_run, sizes = engine._run, []

    def run(chunk, with_input):
        sizes.append(len(chunk))
        if len(chunk) > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real_run(chunk, with_input)

    monkeypatch.setattr(engine, "_run", run)
    np.testing.assert_array_equal(engine.predict_tiles(raw, batch_size=4), want)
    assert sizes[:3] == [3, 2, 1] and engine._serve_batch_cap == 1
    monkeypatch.setattr(engine, "_run", lambda c, w: (_ for _ in ()).throw(
        torch.cuda.OutOfMemoryError("simulated")))
    with pytest.raises(RuntimeError, match="batch_size=1"):
        engine.predict_tiles(raw, batch_size=1)


def test_bf16_engine_tracks_f32(flat):
    raw = np.random.default_rng(8).uniform(0, 2e-3, (2, *NATIVE)).astype(np.float32)
    f32 = _port_engine(flat)
    bf16 = _port_engine(flat, dtype=torch.bfloat16)
    assert next(bf16.model.parameters()).dtype == torch.bfloat16
    p32, i32 = f32(raw)
    p16, i16 = bf16(raw)
    assert p16.dtype == np.float32 and np.isfinite(p16).all()
    np.testing.assert_array_equal(i16, i32)  # normalization stays f32
    print(f"max|bf16 - f32| {np.abs(p16 - p32).max() / SR_HR_MAX:.3e} x hr_max")
    assert np.abs(p16 - p32).max() <= 0.05 * SR_HR_MAX


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(quantize=True), NotImplementedError),
        (dict(int8_scales={}), NotImplementedError),
        (dict(mesh=object()), NotImplementedError),
        (dict(dtype=torch.float16), ValueError),
        (dict(crop_p=0.0), ValueError),
    ],
    ids=["quantize", "int8_scales", "mesh", "float16", "crop_p"],
)
def test_unported_or_invalid_options_raise(flat, kw, err):
    with pytest.raises(err):
        InferenceEngine(
            tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"}),
            _dataset(tcfg, True), params_from_flax(flat), device="cpu", **kw,
        )


@pytest.mark.parametrize("run", ["esr_gen_sr", "rrdb_denoise"])
def test_run_config_loads_like_jax(run):
    path = ROOT / "res/configs/runs" / f"{run}.toml"
    ds, mc = tcfg.load_run_config(path)
    jds, jmc, *_ = jax_load_run_config(path)
    for field in ("scaling", "crop_mode", "batch_size", "name", "directory"):
        assert getattr(ds, field) == getattr(jds, field), field
    assert ds.type.value == jds.type.value
    for half in ("lr", "hr"):
        for field in ("clamp_max", "res"):
            assert getattr(getattr(ds, half), field) == getattr(getattr(jds, half), field)
    assert mc.name.value == jmc.name.value
    for field in ("in_channels", "out_channels", "filters", "residual_blocks", "base_model"):
        assert getattr(mc.model, field) == getattr(jmc.model, field), field


def test_config_rejects_unknown_keys_and_bad_values():
    lr = dict(exps=[20], clamp_max=LR_MAX, res=RES)
    with pytest.raises(TypeError):
        tcfg.DatasetCfg(lr=lr, scalingg="sqrt")
    with pytest.raises(tcfg.ConfigError):
        tcfg.DatasetCfg(lr=lr, scaling="cubic")
    with pytest.raises(tcfg.ConfigError):
        tcfg.DatasetCfg(lr=dict(lr, res=0))
    with pytest.raises(TypeError):  # training-only keys are not part of serving
        tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"}, scan_layers=True)
