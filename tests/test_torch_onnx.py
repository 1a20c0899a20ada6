"""The port's ONNX modules and ONNX checkpoints against the JAX package's, on the CPU.

* `import_onnx_params` of a JAX-exported ONNX (`export_onnx_params`, and
  `export_rrdb_onnx_model`'s full graph): bitwise equal to JAX's import,
  key for key, for RRDB SR and DN and each zoo family at tiny widths
  (SwinIR, SwinFIR, DRCT, HAT, Restormer), DRCT and HAT also in the
  scan-compressed `layers_scan` layout; the port's `export_onnx_params`
  writes the same file, byte for byte;
* the shape fallback: a renamed initializer of a unique shape is matched as
  JAX matches it; nameless initializers of repeated blocks are refused;
* the port's `export_rrdb_onnx_model`: the parsed graph equals JAX's (nodes
  in order with their attributes, initializer names and bytes, inputs and
  outputs), and the files are byte-identical but for the producer name;
* the port's `run_graph` (torch, on the CPU) on JAX's exported graph:
  within 1e-5 of JAX's `run_graph` and of the port's model forward;
* `cli infer`, `serve` and `end2end` with a `.onnx` checkpoint: products
  bitwise equal to the same run from the npz;
* `cli export` from a port fit directory (written by `CheckpointManager`,
  as `fit` writes it) to `.npz` and `.onnx`: serving either, or the fit
  directory itself, gives the same products, bitwise;
* `cli verify --data DIR --device cpu` on synthetic detxy files with a
  locally exported stand-in: every gate passes (JAX's
  `tests/test_verify_gate.py`), with the report keys of JAX's `verify_onnx`.
"""

import contextlib
import functools
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_zoo_common import jax_init, jzoo, port, x_np

from test_cli import _write_run_config
from test_torch_end2end import tiny_setup, write_pps
from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.infer import onnx_export as tex
from xmm_superres_denoise_torch.infer import onnx_import as tim
from xmm_superres_denoise_torch.infer import onnx_runtime_lite as trt
from xmm_superres_denoise_torch.io.fits import read_image, write_image
from xmm_superres_denoise_torch.models import drct as tdrct
from xmm_superres_denoise_torch.models import hat as thaat
from xmm_superres_denoise_torch.models import restormer as trest
from xmm_superres_denoise_torch.models import swinir as tswinir
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from xmm_superres_denoise_torch.utils.weights import flax_tree
from xmm_superres_denoise_tpu import cli as jcli
from xmm_superres_denoise_tpu.infer import onnx_export as jex
from xmm_superres_denoise_tpu.infer import onnx_import as jim
from xmm_superres_denoise_tpu.infer import onnx_runtime_lite as jrt
from xmm_superres_denoise_tpu.models.scan_stack import stack_layer_params

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "docs/convergence_esr_gen/best_params.npz"
F32_TOL = 1e-5

SWIN = dict(img_size=24, patch_size=8, in_chans=1, embed_dim=12, depths=(2,), num_heads=(2,),
            window_size=8, mlp_ratio=2.0, upscale=2, upsampler="pixelshuffle", num_feat=8)
DRCT = dict(img_size=24, patch_size=8, in_chans=1, embed_dim=12, depths=(1, 1),
            num_heads=(2, 2), window_size=8, mlp_ratio=2.0, upscale=2, gc=6, num_feat=8)
HAT = dict(img_size=24, patch_size=1, in_chans=1, embed_dim=12, depths=(1, 1),
           num_heads=(2, 2), window_size=6, mlp_ratio=2.0, upscale=2, squeeze_factor=4,
           num_feat=8, overlap_ratio=1 / 3)
RESTORMER = dict(inp_channels=1, out_channels=1, dim=8, num_blocks=(1, 1, 1, 1),
                 num_refinement_blocks=1, heads=(1, 2, 4, 8))
RRDB_SR = dict(num_filters=8, num_res_blocks=2, num_upsample=1)
RRDB_DN = dict(num_filters=8, num_res_blocks=2)

# name -> (JAX module, port module, input, scan layout, exporter)
FAMILIES = {
    "rrdb-sr": lambda: (jzoo.GeneratorRRDB_SR(**RRDB_SR), GeneratorRRDB_SR(**RRDB_SR),
                        x_np(s=16), False, "params"),
    "rrdb-sr-graph": lambda: (jzoo.GeneratorRRDB_SR(**RRDB_SR), GeneratorRRDB_SR(**RRDB_SR),
                              x_np(s=16), False, "graph"),
    "rrdb-dn-graph": lambda: (jzoo.GeneratorRRDB_DN(**RRDB_DN), GeneratorRRDB_DN(**RRDB_DN),
                              x_np(s=16), False, "graph"),
    "swinir": lambda: (jzoo.SwinIR(**SWIN), tswinir.SwinIR(**SWIN), x_np(), False, "params"),
    "swinfir": lambda: (jzoo.SwinFIR(**SWIN), tswinir.SwinFIR(**SWIN), x_np(), False,
                        "params"),
    "drct": lambda: (jzoo.DRCT(**DRCT), tdrct.DRCT(**DRCT), x_np(), False, "params"),
    "drct-layers_scan": lambda: (jzoo.DRCT(**DRCT), tdrct.DRCT(**DRCT, scan_layers=True),
                                 x_np(), True, "params"),
    "hat": lambda: (jzoo.HAT(**HAT), thaat.HAT(**HAT), x_np(), False, "params"),
    "hat-layers_scan": lambda: (jzoo.HAT(**HAT), thaat.HAT(**HAT, scan_layers=True), x_np(),
                                True, "params"),
    "restormer": lambda: (jzoo.Restormer(**RESTORMER), trest.Restormer(**RESTORMER),
                          x_np(s=16), False, "params"),
}


def _flat(tree, prefix=""):
    return dict(tim.flatten_tree(tree, prefix))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_import_bitwise_equal_to_jax(name, tmp_path):
    jm, tm, x, scan, exporter = FAMILIES[name]()
    v = jax_init(jm, x)
    template_j = stack_layer_params(v["params"]) if scan else v["params"]
    path = tmp_path / "m.onnx"
    if exporter == "graph":
        jex.export_rrdb_onnx_model(jm, v, path)
    else:
        jim.export_onnx_params({"params": template_j}, path)
        # the port writes the same initializer file from the same tree
        tim.export_onnx_params({"params": template_j}, tmp_path / "port.onnx")
        assert (tmp_path / "port.onnx").read_bytes() == path.read_bytes()
    want = _flat(jax.tree_util.tree_map(np.asarray, jim.import_onnx_params(path, template_j)))
    template_t = flax_tree(tm.state_dict(), scan_layers=scan)
    assert sorted(_flat(template_t)) == sorted(want)
    got = _flat(tim.import_onnx_params(path, template_t))
    assert sorted(got) == sorted(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert any(k.startswith("layers_scan/") for k in got) == scan
    print(f"{name}: {len(got)} arrays, max|port - JAX| {worst} (bitwise)")
    # and the imported tree loads into the port's model
    port(tm, {"params": tim.import_onnx_params(path, template_t)})


def test_shape_fallback_matches_jax_and_refuses_ambiguity(tmp_path):
    jm, tm = jzoo.GeneratorRRDB_SR(**RRDB_SR), GeneratorRRDB_SR(**RRDB_SR)
    v = jax_init(jm, x_np(s=16))
    tensors = {}
    for path, leaf in tim.flatten_tree(v["params"]):
        arr = np.asarray(leaf)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        tensors[tim.flax_to_torch_name(path)] = arr
    # an exporter-renamed conv_last weight: a unique shape, matched by shape
    tensors["onnx::Conv_999"] = tensors.pop("conv_last.weight")
    p = tim.write_onnx_initializers(tmp_path / "renamed.onnx", tensors)
    template_t = flax_tree(tm.state_dict())
    got = _flat(tim.import_onnx_params(p, template_t))
    want = _flat(jax.tree_util.tree_map(np.asarray, jim.import_onnx_params(p, v["params"])))
    assert all(np.array_equal(got[k], want[k]) for k in want) and sorted(got) == sorted(want)
    with pytest.raises(ValueError, match="could not match"):
        tim.import_onnx_params(p, template_t, allow_shape_fallback=False)

    # nameless initializers of repeated same-shape Swin blocks: ambiguous
    sw = jzoo.SwinIR(**SWIN)
    sv = jax_init(sw, x_np())
    anon = {}
    for i, (_, leaf) in enumerate(tim.flatten_tree(sv["params"])):
        arr = np.asarray(leaf)
        anon[f"onnx::Conv_{i}"] = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    p = tim.write_onnx_initializers(tmp_path / "anon.onnx", anon)
    template = flax_tree(tswinir.SwinIR(**SWIN).state_dict())
    for imp, tmpl in ((tim.import_onnx_params, template),
                      (jim.import_onnx_params, sv["params"])):
        with pytest.raises(ValueError, match="ambiguous"):
            imp(p, tmpl)


def _rrdb(sr: bool, seed=0):
    jm = jzoo.GeneratorRRDB_SR(**RRDB_SR) if sr else jzoo.GeneratorRRDB_DN(**RRDB_DN)
    tm = GeneratorRRDB_SR(**RRDB_SR) if sr else GeneratorRRDB_DN(**RRDB_DN)
    x = x_np(s=24, seed=seed)
    v = jax_init(jm, x)
    return jm, port(tm, v), v, x


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "dn"])
def test_export_graph_equal_to_jax(tmp_path, sr):
    jm, tm, v, _ = _rrdb(sr)
    pt = tex.export_rrdb_onnx_model(tm, None, tmp_path / "port.onnx")
    pj = jex.export_rrdb_onnx_model(jm, v, tmp_path / "jax.onnx")
    gt, gj = trt.read_onnx_model(pt), trt.read_onnx_model(pj)
    assert gt.inputs == gj.inputs == ["input"] and gt.outputs == gj.outputs == ["output"]
    assert len(gt.nodes) == len(gj.nodes)
    for a, b in zip(gt.nodes, gj.nodes):
        assert (a.op_type, a.inputs, a.outputs, a.name, a.attrs) == (
            b.op_type, b.inputs, b.outputs, b.name, b.attrs)
    assert list(gt.initializers) == list(gj.initializers)
    for k in gj.initializers:
        assert gt.initializers[k].tobytes() == gj.initializers[k].tobytes(), k
    # byte-identical but for the producer name (ModelProto field 2)
    a, b = pt.read_bytes(), pj.read_bytes()
    swap = a.replace(tim._field(2, 2, tex.PRODUCER),
                     tim._field(2, 2, b"xmm_superres_denoise_tpu"), 1)
    print(f"{'SR' if sr else 'DN'} graph: {len(gt.nodes)} nodes, {len(gt.initializers)} "
          f"initializers; files {len(a)} / {len(b)} bytes, identical after the producer "
          f"name: {swap == b}")
    assert swap == b and a != b


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "dn"])
def test_run_graph_matches_jax_and_the_port_forward(tmp_path, sr):
    jm, tm, v, x = _rrdb(sr, seed=3)
    p = jex.export_rrdb_onnx_model(jm, v, tmp_path / "jax.onnx")
    feed = x.transpose(0, 3, 1, 2)
    got = trt.run_graph(trt.read_onnx_model(p), {"input": feed}, device="cpu")["output"]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    want = jrt.run_graph(jrt.read_onnx_model(p), {"input": feed})["output"]
    with torch.no_grad():
        fwd = tm(torch.from_numpy(x)).numpy().transpose(0, 3, 1, 2)
    e_jax, e_fwd = np.abs(got - want).max(), np.abs(got - fwd).max()
    print(f"run_graph {'SR' if sr else 'DN'}: max|port - JAX run_graph| {e_jax:.3e}, "
          f"max|port run_graph - port forward| {e_fwd:.3e} (tol {F32_TOL})")
    assert got.shape == want.shape and e_jax <= F32_TOL and e_fwd <= F32_TOL
    assert 0.0 <= got.min() and got.max() <= 1.0


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Three detxy files, the 32^2 -> 64^2 run config and the trained
    checkpoint as npz and as JAX's full ONNX graph."""
    from xmm_superres_denoise_tpu.models import GeneratorRRDB_SR as JaxSR
    from xmm_superres_denoise_tpu.train.checkpoints import load_params_npz

    tmp = tmp_path_factory.mktemp("onnx_cli")
    g = np.random.default_rng(0)
    for i in range(3):
        hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0, "CRVAL1": 150.0,
               "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0}
        write_image(tmp / f"det{i}.fits", g.poisson(2.0, (28, 30)).astype(np.int32), hdr)
    model = JaxSR()
    params = load_params_npz(CKPT, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1))))
    onnx = jex.export_rrdb_onnx_model(model, params, tmp / "weights.onnx")
    return tmp, _write_run_config(tmp), onnx


def _products(listing):
    return [read_image(p[k])[0] for p in listing for k in ("input", "prediction")]


def _serve(served, ckpt, out, *flags):
    tmp, run, _ = served
    return _run(tcli.main, ["serve", tmp / "det*.fits", "--checkpoint", ckpt, "--out",
                            tmp / out, "--run_config", run, "--batch", 2, "--device", "cpu",
                            *flags])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_cli_infer_and_serve_from_onnx_bitwise_equal_to_npz(served, mode):
    tmp, run, onnx = served
    flags = ("--bf16",) if mode == "bf16" else ()
    rc_o, lo = _serve(served, onnx, f"onnx_{mode}", *flags)
    rc_n, ln = _serve(served, CKPT, f"npz_{mode}", *flags)
    assert rc_o == rc_n == 0 and len(lo) == len(ln) == 3
    for a, b in zip(_products(lo), _products(ln)):
        assert np.array_equal(a, b)
    outs = []
    for ckpt in (onnx, CKPT):
        rc, out = _run(tcli.main, ["infer", "--fits", tmp / "det0.fits", "--checkpoint", ckpt,
                                   "--out", tmp / f"infer_{ckpt.suffix[1:]}_{mode}",
                                   "--run_config", run, "--device", "cpu", *flags])
        assert rc == 0 and sorted(out) == ["input", "prediction"]
        outs.append(_products([out]))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    print(f"{mode}: serve and infer products from the ONNX graph bitwise equal to the npz's")


def test_cli_end2end_from_onnx_bitwise_equal_to_npz(tmp_path, monkeypatch):
    run, res, npz = tiny_setup(tmp_path)
    monkeypatch.setattr(tcli, "load_run_config", functools.partial(tcli.load_run_config,
                                                                   res_dir=res))
    pps = write_pps(tmp_path / "pps", n=5000)
    from xmm_superres_denoise_torch.models.registry import build_model
    from xmm_superres_denoise_torch.utils.weights import load_params_npz, params_from_flax

    ds, mc, *_ = tcli.load_run_config(run)
    model = build_model(mc, (416, 416), (832, 832))
    model.load_state_dict(params_from_flax(load_params_npz(npz, model), model))
    onnx = tex.export_rrdb_onnx_model(model, None, tmp_path / "tiny.onnx")
    outs = []
    for ckpt in (onnx, npz):
        rc, out = _run(tcli.main, ["end2end", "--pps", pps, "--checkpoint", ckpt, "--run_config",
                                   run, "--out", tmp_path / ckpt.suffix[1:], "--device", "cpu"])
        assert rc == 0
        outs.append([read_image(out[k])[0] for k in ("detxy", "input", "prediction")])
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


def _fit_dir(root: Path, run):
    """A port fit directory: two checkpoints written by `CheckpointManager`
    as `fit` writes them, the trained weights the best (step 1)."""
    from xmm_superres_denoise_torch.models.registry import build_model
    from xmm_superres_denoise_torch.train.checkpoints import CheckpointManager
    from xmm_superres_denoise_torch.train.steps import TrainState
    from xmm_superres_denoise_torch.utils.weights import load_params_npz, params_from_flax

    ds, mc, *_ = tcli.load_run_config(run)
    model = build_model(mc, (32, 32), (64, 64))
    model.load_state_dict(params_from_flax(load_params_npz(CKPT, model), model))
    mngr = CheckpointManager(root)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4))
    mngr.save(1, state, val_loss=0.25)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    mngr.save(2, state, val_loss=0.75)
    return root


def test_cli_export_from_a_fit_dir_serves_the_same_products(served, tmp_path):
    _, run, _ = served
    fit = _fit_dir(tmp_path / "fit" / "esr_gen", run)
    listings = {}
    for suffix in ("npz", "onnx"):
        out = tmp_path / f"exported.{suffix}"
        rc, rep = _run(tcli.main, ["export", "--checkpoint", fit, "--out", out,
                                   "--run_config", run])
        assert rc == 0 and rep == {"exported": str(out), "from_step": 1}
        rc, listings[suffix] = _serve(served, out, f"exported_{suffix}")
        assert rc == 0
    rc, listings["fit"] = _serve(served, fit, "fit_dir")
    rc_n, listings["trained npz"] = _serve(served, CKPT, "trained_npz")
    assert rc == rc_n == 0
    ref = _products(listings["trained npz"])
    for name, listing in listings.items():
        assert all(np.array_equal(a, b) for a, b in zip(_products(listing), ref)), name
    # a directory that no port fit wrote (an orbax checkpoint, say) is refused
    (tmp_path / "orbax").mkdir()
    rc, _ = _serve(served, tmp_path / "orbax", "orbax")
    assert rc == 2
    rc, _ = _run(tcli.main, ["export", "--checkpoint", tmp_path / "orbax", "--out",
                             tmp_path / "x.npz", "--run_config", run])
    assert rc == 2


def test_cli_verify_passes_on_a_local_stand_in(tmp_path, monkeypatch):
    run, res, npz = tiny_setup(tmp_path)
    monkeypatch.setattr(tcli, "load_run_config", functools.partial(tcli.load_run_config,
                                                                   res_dir=res))
    from xmm_superres_denoise_torch.models.registry import build_model
    from xmm_superres_denoise_torch.utils.weights import load_params_npz, params_from_flax
    from xmm_superres_denoise_tpu.infer.verify import verify_onnx as jax_verify

    ds, mc, *_ = tcli.load_run_config(run)
    model = build_model(mc, (416, 416), (832, 832))
    model.load_state_dict(params_from_flax(load_params_npz(npz, model), model))
    onnx = tex.export_rrdb_onnx_model(model, None, tmp_path / "stand_in.onnx")
    data = tmp_path / "data"
    g = np.random.default_rng(5)
    for i in range(2):
        write_image(data / f"pn_{i}_detxy_image_20ks.fits",
                    g.poisson(1.0 + i, (411, 403)).astype(np.int32), {"EXPOSURE": 20_000.0})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main([str(a) for a in ["verify", "--onnx", onnx, "--run_config", run,
                                         "--data", data, "--device", "cpu"]])
    report = json.loads(out.getvalue())
    assert rc == 0 and report["passed"] and report["pixel_gate_passed"], report
    assert report["runtime"] == "lite" and len(report["files"]) == 2
    for row in report["files"]:
        assert row["max_abs_diff"] <= 1e-3 and row["psnr_vs_onnx"] > 40.0
        assert row["ssim_vs_onnx"] > 0.99
    assert report["int8_gate_passed"] and report["int8_psnr_db"] >= 40.0
    ds_j, mc_j, *_ = jcli.load_run_config(run, res_dir=res)
    want = jax_verify(onnx, ds_j, mc_j, sorted(data.glob("*.fits*")), int8=True)
    assert sorted(report) == sorted(want)
    assert [sorted(r) for r in report["files"]] == [sorted(r) for r in want["files"]]
    print(f"verify: port max|diff| {[r['max_abs_diff'] for r in report['files']]}, int8 "
          f"{report['int8_psnr_db']} dB; JAX int8 {want['int8_psnr_db']} dB, passed "
          f"{want['passed']}")
    # no files: refused, as JAX's CLI refuses
    (tmp_path / "empty").mkdir()
    rc, err = _run(tcli.main, ["verify", "--onnx", onnx, "--run_config", run, "--data",
                               tmp_path / "empty", "--device", "cpu"])
    assert rc == 2 and err == {"error": "no input FITS files found"}
