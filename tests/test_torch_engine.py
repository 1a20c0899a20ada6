"""The port's serving engine against the JAX package's, on the CPU: the same
synthetic detxy FITS through both `InferenceEngine`s at lr.res = 64 with the
trained esr_gen weights, products compared.

Tolerance: predictions to 1e-5 x hr clamp_max (the products' full scale),
far below the 1e-3 bar; the denormalized inputs to 1e-6 x lr clamp_max.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.run_file import (
    InferenceEngine,
    infer_file,
    serve_files,
)
from xmm_superres_denoise_torch.io.fits import write_image
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.utils import profiling as tprof
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


@pytest.mark.parametrize("n", [5, 6, 1])
def test_tiles_chunking_matches_one_call(flat, n):
    """`run_tiles` at batch 2 equals one call to within the f32 class, and
    equals the engine called chunk by chunk bit for bit: each chunk's rows
    land in place. The CPU's convolutions round an image alone otherwise
    than in a batch, so at N = 5, whose last chunk is one image, the single
    call agrees only within the f32 class; at N = 6 and 1 bit for bit."""
    engine = _port_engine(flat)
    raw = np.random.default_rng(6).uniform(0, 2e-3, (n, *NATIVE)).astype(np.float32)
    pred, inp = engine(raw)
    tiles_pred, tiles_inp = engine.run_tiles(raw, batch_size=2)
    assert tiles_pred.shape == (n, 2 * RES, 2 * RES) and tiles_pred.dtype == np.float32
    np.testing.assert_allclose(tiles_pred, pred, rtol=0, atol=1e-5 * SR_HR_MAX)
    np.testing.assert_array_equal(tiles_inp, inp)
    chunks = [engine(raw[i : i + 2]) for i in range(0, n, 2)]
    np.testing.assert_array_equal(tiles_pred, np.concatenate([c[0] for c in chunks]))
    np.testing.assert_array_equal(tiles_inp, np.concatenate([c[1] for c in chunks]))
    if n % 2 == 0 or n == 1:
        np.testing.assert_array_equal(tiles_pred, pred)
    np.testing.assert_array_equal(engine.predict_tiles(raw, batch_size=2), tiles_pred)


def test_run_tiles_arrays_outlive_the_next_call(flat):
    """Each call's arrays are its own: a second call (whose chunks reuse the
    first call's host buffers) leaves the first call's outputs as they were,
    as `serve_files`' writers, still holding them, need."""
    engine = _port_engine(flat)
    g = np.random.default_rng(14)
    first = engine.run_tiles(g.uniform(0, 2e-3, (5, *NATIVE)).astype(np.float32), batch_size=2)
    kept = [a.copy() for a in first]
    second = engine.run_tiles(g.uniform(0, 2e-3, (5, *NATIVE)).astype(np.float32), batch_size=2)
    for a, b, k in zip(first, second, kept):
        assert not np.shares_memory(a, b)
        np.testing.assert_array_equal(a, k)
    assert not np.array_equal(first[0], second[0])


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


@pytest.mark.parametrize("at", [1, 3], ids=["second-chunk", "after-a-readback"])
def test_out_of_memory_mid_call_returns_every_row(flat, monkeypatch, at):
    """A call of 8 at batch 2 whose chunk `at` runs out of memory (the 4th
    launch comes after the first chunk was copied into the call's arrays) is
    rerun at batch 1 and returns every row as the engine does at batch 1."""
    engine = _port_engine(flat)
    raw = np.random.default_rng(15).uniform(0, 2e-3, (8, *NATIVE)).astype(np.float32)
    want = engine.run_tiles(raw, batch_size=1)
    real_run, launched = engine._run, []

    def run(chunk, with_input):
        launched.append(len(chunk))
        if len(launched) == at + 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real_run(chunk, with_input)

    monkeypatch.setattr(engine, "_run", run)
    got = engine.run_tiles(raw, batch_size=2)
    assert launched == [2] * (at + 1) + [1] * 8 and engine._serve_batch_cap == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _engine_spans(path):
    """{name: [(start, end), ...]} of the `engine.*` spans in a Chrome trace."""
    spans: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and str(e.get("name")).startswith("engine."):
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return spans


def _inside(inner, outers):
    return any(a <= inner[0] and inner[1] <= b for a, b in outers)


def test_run_tiles_spans_nest_by_engine_stage(flat, tmp_path):
    """Under `utils/profiling.trace`, `run_tiles` of 5 images at batch 2 is
    one `engine.call` holding 3 launches (each a host staging and a shard's
    upload, and a forward) and 3 readbacks, each of which holds the gather
    of its chunk into the call's arrays: no gather is left after the last
    readback."""
    engine = _port_engine(flat)
    raw = np.random.default_rng(10).uniform(0, 2e-3, (5, *NATIVE)).astype(np.float32)
    engine(raw[0])  # untraced
    with tprof.trace(tmp_path):
        engine.run_tiles(raw, batch_size=2)
    (path,) = tmp_path.glob("*.pt.trace.json")
    spans = _engine_spans(path)
    print({k: len(v) for k, v in spans.items()})
    assert {k: len(v) for k, v in spans.items()} == {  # no event to wait on, on the CPU
        "engine.call": 1, "engine.launch": 3, "engine.upload": 6, "engine.forward": 3,
        "engine.readback": 3, "engine.first_touch": 3, "engine.gather": 3,
    }
    assert all(_inside(s, spans["engine.call"]) for v in spans.values() for s in v)
    for stage in ("engine.upload", "engine.forward"):
        assert all(_inside(s, spans["engine.launch"]) for s in spans[stage])
    assert not any(_inside(s, spans["engine.launch"]) for s in spans["engine.readback"])
    for readback in spans["engine.readback"]:
        assert sum(_inside(g, [readback]) for g in spans["engine.gather"]) == 1
        assert sum(_inside(t, [readback]) for t in spans["engine.first_touch"]) == 1
    last_readback_end = max(b for _, b in spans["engine.readback"])
    assert all(a < last_readback_end for a, _ in spans["engine.gather"])


def test_readback_touches_the_rows_before_it_waits_and_gathers(tmp_path):
    """`_Readback.result` of a chunk with an event (as on a card): inside
    `engine.readback`, the first touch of the output rows, then the wait on
    the event, then the gather, one after another."""
    from xmm_superres_denoise_torch.infer.run_file import _Readback

    class Event:  # a recorded CUDA event, already complete
        def synchronize(self):
            pass

    bufs = [torch.arange(12, dtype=torch.float32).reshape(3, 2, 2), torch.ones(3, 2)]
    chunk = _Readback([(bufs, Event())], valid=3)
    outs = chunk.empty(5)
    with tprof.trace(tmp_path):
        chunk.result(outs, row=1)
    np.testing.assert_array_equal(outs[0][1:4], bufs[0].numpy())
    np.testing.assert_array_equal(outs[1][1:4], bufs[1].numpy())
    (path,) = tmp_path.glob("*.pt.trace.json")
    spans = _engine_spans(path)
    assert {k: len(v) for k, v in spans.items()} == {
        "engine.readback": 1, "engine.first_touch": 1, "engine.readback_wait": 1,
        "engine.gather": 1}
    (touch,), (wait,), (gather,) = (spans[k] for k in (
        "engine.first_touch", "engine.readback_wait", "engine.gather"))
    assert all(_inside(s, spans["engine.readback"]) for s in (touch, wait, gather))
    assert touch[1] <= wait[0] and wait[1] <= gather[0]


def _zoo_engine():
    """A SwinIR of two Swin blocks (the second shifted) at 16^2 -> 32^2, its
    weights seeded."""
    from benchmark import harness
    from benchmark.programs import swinir as program
    from benchmark.reference import swinir as reference

    cfg = dict(harness.load_cell("swinir_bf16_bulk")["cfg"], embed_dim=12, depths=[2],
               num_heads=[2], window_size=4, img_size=16, patch_size=1, lr_res=16, hr_res=32,
               batch_size=2)
    params = reference.make_params(cfg, 0, "cpu", torch.float32)
    return InferenceEngine(program.model_config(cfg), program.dataset_config(cfg), params,
                           device="cpu")


def _serve_with_record_function_counted(engine, raw, monkeypatch):
    entered = []
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", lambda *a, **k: entered.append(a))
    engine.run_tiles(raw, batch_size=2)
    engine.predict_tiles(raw, batch_size=2)
    engine(raw[0])
    return entered


def test_serving_enters_no_record_function_with_the_profiler_off(flat, monkeypatch):
    engine = _port_engine(flat)
    raw = np.random.default_rng(11).uniform(0, 2e-3, (3, *NATIVE)).astype(np.float32)
    assert _serve_with_record_function_counted(engine, raw, monkeypatch) == []


def test_zoo_serving_enters_no_record_function_with_the_profiler_off(monkeypatch):
    """The same through a SwinIR, whose blocks open the `zoo.*` stage spans."""
    raw = np.random.default_rng(11).uniform(0, 2e-3, (3, 14, 13)).astype(np.float32)
    assert _serve_with_record_function_counted(_zoo_engine(), raw, monkeypatch) == []


def test_out_of_memory_retry_stays_inside_one_call_span(flat, tmp_path, monkeypatch):
    """A chunk of 4 that runs out of memory in its launch is launched again
    as two of 2 inside the same `engine.call`: three launches, two forwards
    and readbacks, each readback holding its chunk's gather."""
    engine = _port_engine(flat)
    raw = np.random.default_rng(13).uniform(0, 2e-3, (4, *NATIVE)).astype(np.float32)
    real = engine._launch

    def launch(rep, host, with_input):
        if len(host) > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(rep, host, with_input)

    monkeypatch.setattr(engine, "_launch", launch)
    with tprof.trace(tmp_path):
        engine.predict_tiles(raw, batch_size=4)
    assert engine._serve_batch_cap == 2
    (path,) = tmp_path.glob("*.pt.trace.json")
    spans = _engine_spans(path)
    assert {k: len(spans[k]) for k in ("engine.call", "engine.launch", "engine.forward",
                                       "engine.readback", "engine.gather")} == {
        "engine.call": 1, "engine.launch": 3, "engine.forward": 2, "engine.readback": 2,
        "engine.gather": 2,
    }
    assert all(_inside(s, spans["engine.call"]) for v in spans.values() for s in v)
    assert all(_inside(g, spans["engine.readback"]) for g in spans["engine.gather"])


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
        (dict(quantize=True, int8_scales={"conv_first": 1.0}), ValueError),
        (dict(int8_scales={}), ValueError),
        (dict(mesh=object()), TypeError),  # not a sequence of devices
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
    # scan_layers is accepted by the config, as by JAX's, and refused by the
    # registry for a model that has no scanned form (JAX's ValueError)
    scanned = tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"}, scan_layers=True)
    with pytest.raises(ValueError, match="scan_layers"):
        build_model(scanned, (RES, RES), (2 * RES, 2 * RES))
