"""The port's serving engine on a data mesh (`InferenceEngine(mesh=...)`,
`parallel/mesh.py: serving_devices`, `cli --mesh_data`), on the CPU.

The mesh is N replicas on the host, `("cpu",) * N`, the counterpart of the
JAX package's `make_mesh(data=N)` over conftest's 8 virtual CPU devices.
Engine: the trained esr_gen checkpoint (32 filters, 4 RRDB) at 32^2 ->
64^2, with 30 x 28 rate images.

Tolerances, printed with what each case measured:
- the mesh engine against the port's single-device engine: rtol 1e-6,
  atol 1e-7 (JAX's own bound, `tests/test_inference.py`), f32 and bf16;
- against JAX's mesh engine: the f32 class, 1e-5 on the [0, 1] scale
  (1e-5 x hr clamp_max on the products);
- int8 scales: max-abs of f32 activations summed in another order, rtol
  1e-5 against JAX's; equal to the single-device engine's.
"""

import contextlib
import io
import json
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from test_cli import _write_run_config
from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.http_server import InferenceHTTPServer
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, infer_file
from xmm_superres_denoise_torch.io.fits import read_image, write_image
from xmm_superres_denoise_torch.ops import int8_forward
from xmm_superres_denoise_torch.parallel.mesh import serving_devices
from xmm_superres_denoise_torch.utils.weights import params_from_flax
from xmm_superres_denoise_tpu import cli as jcli
from xmm_superres_denoise_tpu import config as jcfg
from xmm_superres_denoise_tpu.infer.run_file import InferenceEngine as JaxEngine
from xmm_superres_denoise_tpu.parallel import make_mesh

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "docs/convergence_esr_gen/best_params.npz"
LR_MAX, SR_HR_MAX = 0.0022336, 0.0005584
NATIVE = (30, 28)
RTOL, ATOL = 1e-6, 1e-7


def _dataset(mod):
    return mod.DatasetCfg(
        lr=mod.LrDatasetCfg(bkg=0, exps=[20], clamp_max=LR_MAX, res=32),
        hr=mod.HrDatasetCfg(exp=100, clamp_max=SR_HR_MAX, res=64),
        scaling="sqrt", type="boring",
    )


MODEL = tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"})


@pytest.fixture(scope="module")
def params():
    return params_from_flax(CKPT)


@pytest.fixture(scope="module")
def jax_tree():
    tree: dict = {}
    with np.load(CKPT) as npz:
        for key in npz.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(npz[key])
    return tree


def _jax_engine(tree, n, **kw):
    model = jcfg.ModelCfg(name="esr_gen", model=jcfg.RrdbCfg(base_model="esr_gen"),
                          optimizer=jcfg.OptimizerCfg(learning_rate=1e-4))
    return JaxEngine(model, _dataset(jcfg), tree, mesh=make_mesh(data=n), **kw)


def _engine(params, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return InferenceEngine(MODEL, _dataset(tcfg), params, mesh=mesh, **kw)


def _raw(b, seed):
    return np.random.default_rng(seed).uniform(0, 2e-3, (b, *NATIVE)).astype(np.float32)


@pytest.mark.parametrize("data,count,want", [
    (0, 4, ["cuda:0"]), (1, 4, ["cuda:0"]), (-1, 3, ["cuda:0", "cuda:1", "cuda:2"]),
    (2, 4, ["cuda:0", "cuda:1"]), (3, 2, None), (-1, 0, None), (-2, 4, None),
], ids=["0", "1", "all", "two", "too-many", "no-card", "invalid"])
def test_serving_devices(monkeypatch, data, count, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if want is None:
        with pytest.raises(ValueError, match="card|expected"):
            serving_devices(data)
    else:
        assert [str(d) for d in serving_devices(data)] == want


def test_serving_devices_on_the_cpu():
    assert serving_devices(4, "cpu") == (torch.device("cpu"),) * 4
    assert serving_devices(-1, "cpu") == serving_devices(0, "cpu") == (torch.device("cpu"),)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mesh_engine_matches_single_device(params, dtype, n):
    single = _engine(params, dtype=dtype)
    mesh = _engine(params, mesh=("cpu",) * n, dtype=dtype)
    assert mesh.devices == (torch.device("cpu"),) * n and len(mesh._replicas) == n
    assert mesh._replicas[0].model is not mesh._replicas[1].model
    for b in (1, 5, 8):
        raw = _raw(b, seed=b)
        (p0, i0), (p1, i1) = single(raw), mesh(raw)
        assert p1.shape == (b, 64, 64) and i1.shape == (b, 32, 32)
        print(f"{dtype} N={n} batch {b}: max|mesh - single| prediction {np.abs(p1 - p0).max():.3e},"
              f" input {np.abs(i1 - i0).max():.3e} (rtol {RTOL}, atol {ATOL})")
        np.testing.assert_allclose(p1, p0, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(i1, i0, rtol=RTOL, atol=ATOL)
    raw = _raw(11, seed=11)  # chunks of 4, 4 and a tail of 3 padded to the mesh
    want = single.predict_tiles(raw, batch_size=4)
    got, got_in = mesh.run_tiles(raw, batch_size=4)
    print(f"{dtype} N={n} tiles of 11 at batch 4: max|mesh - single| "
          f"{np.abs(got - want).max():.3e}")
    assert got.shape == (11, 64, 64) and got_in.shape == (11, 32, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mesh.predict_tiles(raw, batch_size=4), got, rtol=RTOL, atol=ATOL)


def _by_shard(single, raw, batch, n):
    """The single-device engine called on each shard the mesh runs: every
    chunk of `batch` padded to a multiple of `n` by its last image and split
    (a chunk of 1 unsplit), the outputs gathered in order and trimmed."""
    preds, inps = [], []
    for i in range(0, len(raw), batch):
        chunk = raw[i : i + batch]
        padded = chunk
        if len(chunk) > 1:
            padded = np.concatenate([chunk, np.repeat(chunk[-1:], (-len(chunk)) % n, axis=0)])
        step = len(padded) // (n if len(chunk) > 1 else 1)
        outs = [single(padded[j : j + step]) for j in range(0, len(padded), step)]
        preds.append(np.concatenate([o[0] for o in outs])[: len(chunk)])
        inps.append(np.concatenate([o[1] for o in outs])[: len(chunk)])
    return np.concatenate(preds), np.concatenate(inps)


@pytest.mark.parametrize("n,images,batch", [(2, 5, 2), (2, 9, 3), (4, 5, 2)],
                         ids=["2x5-at-2", "2x9-at-3", "4x5-at-2"])
def test_mesh_run_tiles_puts_every_shard_in_its_rows(params, n, images, batch):
    """Each shard is copied into its own rows of the call's arrays, the mesh
    padding trimmed: equal bit for bit to the single-device engine run on
    the same shards, and to its `run_tiles` within the mesh tolerance. At
    9 at batch 3 every chunk has a padded shard; at 5 over 4 replicas at
    batch 2 two of each full chunk's shards are all padding."""
    single = _engine(params)
    mesh = _engine(params, mesh=("cpu",) * n)
    raw = _raw(images, seed=40 + images)
    got, got_in = mesh.run_tiles(raw, batch_size=batch)
    want, want_in = _by_shard(single, raw, batch, n)
    assert got.shape == (images, 64, 64) and got_in.shape == (images, 32, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_in, want_in)
    tiles, tiles_in = single.run_tiles(raw, batch_size=batch)
    np.testing.assert_allclose(got, tiles, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_in, tiles_in)
    np.testing.assert_array_equal(mesh.predict_tiles(raw, batch_size=batch), got)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_engine_matches_jax_mesh_engine(params, jax_tree, n):
    mesh = _engine(params, mesh=("cpu",) * n)
    jax_engine = _jax_engine(jax_tree, n)
    raw = _raw(5, seed=20 + n)  # padded to a multiple of the mesh inside both
    (pt, it), (pj, ij) = mesh(raw), jax_engine(raw)
    err, err_in = np.abs(pt - pj).max(), np.abs(it - ij).max()
    print(f"N={n}, batch 5: max|port mesh - JAX mesh| prediction {err / SR_HR_MAX:.3e} x hr_max "
          f"(tol 1e-5), input {err_in / LR_MAX:.3e} x lr_max (tol 1e-6)")
    assert pt.shape == pj.shape == (5, 64, 64)
    assert err <= 1e-5 * SR_HR_MAX and err_in <= 1e-6 * LR_MAX


def test_mesh_int8_calibrates_once_on_the_whole_batch(params, jax_tree, monkeypatch):
    real, seen = int8_forward.calibrate_int8_scales, []

    def counted(model, p, calib, device="cuda:0"):
        seen.append(tuple(calib.shape))
        return real(model, p, calib, device=device)

    monkeypatch.setattr(int8_forward, "calibrate_int8_scales", counted)
    raw = _raw(5, seed=30)
    mesh = _engine(params, mesh=("cpu",) * 2, quantize=True)
    pm, _ = mesh(raw)
    pm_again, _ = mesh(_raw(3, seed=31))
    assert seen == [(5, 32, 32, 1)], seen  # once, the whole unpadded batch on mesh[0]
    assert all(r.forward_i8 is not None for r in mesh._replicas)
    single = _engine(params, quantize=True)
    ps, _ = single(raw)
    assert mesh.int8_scales == single.int8_scales
    # JAX's mesh engine calibrates in `_ensure_built`, on the unsharded batch
    # before its placement; its int8 forward (held to the port's on shared
    # scales by test_torch_int8_forward.py) is not compiled here
    jax_engine = _jax_engine(jax_tree, 2, quantize=True)
    jax_engine._ensure_built(jnp.asarray(raw))
    rel = max(abs(mesh.int8_scales[k] - v) / v for k, v in jax_engine.int8_scales.items())
    print(f"int8 mesh N=2: {len(mesh.int8_scales)} scales, max relative difference to JAX's mesh "
          f"engine {rel:.3e} (rtol 1e-5); max|mesh - single| {np.abs(pm - ps).max():.3e}")
    assert sorted(mesh.int8_scales) == sorted(jax_engine.int8_scales) and rel <= 1e-5
    np.testing.assert_allclose(pm, ps, rtol=RTOL, atol=ATOL)
    assert pm_again.shape == (3, 64, 64)


def test_mesh_spans_mark_every_shard(params):
    """5 images at batch 3 over two CPU replicas: two launches, each
    forwarding both shards inside it, and two readbacks."""
    mesh = _engine(params, mesh=("cpu",) * 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mesh.run_tiles(_raw(5, seed=9), batch_size=3)
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith("engine."):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert {k: len(spans[k]) for k in ("engine.launch", "engine.forward",
                                       "engine.readback")} == {
        "engine.launch": 2, "engine.forward": 4, "engine.readback": 2}
    for launch in spans["engine.launch"]:
        inside = [f for f in spans["engine.forward"] if launch[0] <= f[0] and f[1] <= launch[1]]
        assert len(inside) == 2


def test_mesh_rejects_what_is_not_a_device_sequence(params):
    with pytest.raises(TypeError):
        _engine(params, mesh="cpu")
    with pytest.raises(ValueError):
        _engine(params, mesh=())


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _write_detxy(path, seed):
    hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0, "CRVAL1": 150.0,
           "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0,
           "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN"}
    g = np.random.default_rng(seed)
    return write_image(path, g.poisson(2.0, NATIVE).astype(np.int32), hdr)


def test_cli_serve_mesh_data_2_matches_one_device_and_the_jax_cli(tmp_path, caplog):
    for i in range(3):
        _write_detxy(tmp_path / f"det{i}.fits", seed=i)
    run = _write_run_config(tmp_path)
    common = [tmp_path / "det*.fits", "--checkpoint", CKPT, "--run_config", run, "--batch", 3]
    with caplog.at_level("INFO", logger="xmmsr"):
        rc_m, mesh = _run(tcli.main, ["serve", *common, "--out", tmp_path / "mesh",
                                      "--mesh_data", 2, "--device", "cpu"])
    assert "serving mesh" in caplog.text
    rc_1, one = _run(tcli.main, ["serve", *common, "--out", tmp_path / "one", "--device", "cpu"])
    rc_j, jax = _run(jcli.main, ["serve", *common, "--out", tmp_path / "jax", "--mesh_data", 2])
    assert rc_m == rc_1 == rc_j == 0 and len(mesh) == len(one) == len(jax) == 3
    for m, o, j in zip(mesh, one, jax):
        assert Path(m["prediction"]).name == Path(j["prediction"]).name
        pm, po, pj = (read_image(x["prediction"])[0] for x in (m, o, j))
        err_j = np.abs(pm - pj).max()
        print(f"{Path(m['file']).name}: max|mesh - one device| {np.abs(pm - po).max():.3e}, "
              f"max|mesh - JAX --mesh_data 2| {err_j / SR_HR_MAX:.3e} x hr_max (tol 1e-5)")
        np.testing.assert_allclose(pm, po, rtol=RTOL, atol=ATOL)
        assert err_j <= 1e-5 * SR_HR_MAX


def test_http_server_over_a_mesh_engine(params, tmp_path):
    """One engine lock serialises device work; a request (batch 1) runs on
    mesh[0], and its product equals `infer_file`'s through the mesh engine
    and through one device."""
    mesh = _engine(params, mesh=("cpu",) * 2)
    src = _write_detxy(tmp_path / "req.fits", seed=5)
    server = InferenceHTTPServer(("127.0.0.1", 0), mesh, hr_exp_ks=100.0, model_name="esr_gen")
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d/infer" % server.server_address[1]
        blobs = []
        for _ in range(2):
            req = urllib.request.Request(url, data=src.read_bytes(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                blobs.append(read_image(r.read())[0])
    finally:
        server.shutdown()
        thread.join(timeout=10.0)
        server.server_close()
    _, p_mesh = infer_file(src, mesh, tmp_path / "mesh", 100.0, "esr_gen")
    _, p_one = infer_file(src, _engine(params), tmp_path / "one", 100.0, "esr_gen")
    want = read_image(p_mesh)[0]
    print(f"http over the mesh engine: max|http - infer_file on one device| "
          f"{np.abs(blobs[0] - read_image(p_one)[0]).max():.3e}")
    for got in blobs:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(want, read_image(p_one)[0], rtol=RTOL, atol=ATOL)
