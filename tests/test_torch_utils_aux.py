"""The port's auxiliary utilities against the JAX package's, on the CPU:
the epoch image logger (`utils/imagelogger.py`) and its wiring into the
trainer, the profiling helpers (`utils/profiling.py`), `setup_logging`
(`utils/logging.py`) and the kernel build cache's directory policy
(`utils/jitcache.py`).

Tolerances, printed with what each case measured: the logger's FITS within
1e-6 relative of JAX's (the same denormalisation in f32); its SSIM map, as
JAX's, within 2e-6 of a float64 evaluation; the fit's generated FITS, from
the same JAX init, within 1e-5 x hr clamp_max (the f32 class).
"""

import importlib
import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import LOSS_WEIGHTS, SQRT_TABLE, configs, jcfg, state_dict_of, tcfg

from xmm_superres_denoise_torch.data.datamodule import XmmDataModule
from xmm_superres_denoise_torch.io.fits import read_image
from xmm_superres_denoise_torch.ops import cuda_build
from xmm_superres_denoise_torch.ops.stretch import Normalizer
from xmm_superres_denoise_torch.train import Trainer, create_loss
from xmm_superres_denoise_torch.utils import imagelogger as til
from xmm_superres_denoise_torch.utils import jitcache
from xmm_superres_denoise_torch.utils import logging as tlog
from xmm_superres_denoise_torch.utils import profiling as tprof

jil = importlib.import_module("xmm_superres_denoise_tpu.utils.imagelogger")
jprof = importlib.import_module("xmm_superres_denoise_tpu.utils.profiling")
jlog = importlib.import_module("xmm_superres_denoise_tpu.utils.logging")
jstretch = importlib.import_module("xmm_superres_denoise_tpu.ops.stretch")
jdm = importlib.import_module("xmm_superres_denoise_tpu.data.datamodule")
jtrain = importlib.import_module("xmm_superres_denoise_tpu.train")
jmesh = importlib.import_module("xmm_superres_denoise_tpu.parallel.mesh")

ROOT = Path(__file__).resolve().parents[1]
LR_MAX, SR_HR_MAX = 0.0022336, 0.0005584


def _display_arrays(seed=0, b=3, res=16, label=True):
    g = np.random.default_rng(seed)
    lr = g.uniform(0.0, 1.0, (b, res, res, 1)).astype(np.float32)
    preds = g.uniform(0.0, 1.0, (b, 2 * res, 2 * res, 1)).astype(np.float32)
    hr = (np.clip(preds + 0.1 * g.normal(size=preds.shape), 0, 1).astype(np.float32)
          if label else None)
    return lr, preds, hr


def _loggers(tmp_path, every=1):
    kw = dict(log_every_n_epochs=every, lr_exp_ks=20.0, hr_exp_ks=100.0)
    port = til.ImageLogger(tmp_path / "port", Normalizer(LR_MAX, SR_HR_MAX, "sqrt"), **kw)
    jax = jil.ImageLogger(tmp_path / "jax", jstretch.Normalizer(LR_MAX, SR_HR_MAX, "sqrt"), **kw)
    return port, jax


def _grids(monkeypatch):
    """Record the (rows, columns) of every figure either logger makes."""
    plt = pytest.importorskip("matplotlib.pyplot")
    real, seen = plt.subplots, []

    def subplots(n, m, **kw):
        seen.append((n, m))
        return real(n, m, **kw)

    monkeypatch.setattr(plt, "subplots", subplots)
    return seen


@pytest.mark.parametrize("label", [True, False], ids=["label", "no-label"])
def test_image_logger_writes_what_the_jax_logger_writes(tmp_path, monkeypatch, label):
    grids = _grids(monkeypatch)
    lr, preds, hr = _display_arrays(label=label)
    port, jax = _loggers(tmp_path)
    pp = port.log_batch(2, lr, preds, hr, max_images=2)
    jp = jax.log_batch(2, lr, preds, hr, max_images=2)
    assert grids == [(2, 5 if label else 2)] * 2  # input, generated[, label, difference, ssim]
    dirs = tmp_path / "port/epoch_00002", tmp_path / "jax/epoch_00002"
    names = [sorted(p.name for p in d.iterdir()) for d in dirs]
    assert names[0] == names[1] == ["display.png"] + sorted(
        f"display_{i}_{k}.fits.gz" for i in range(2) for k in ("generated", "input"))
    assert pp.name == jp.name == "display.png" and pp.stat().st_size > 0
    worst = 0.0
    for name in names[0][1:]:
        (a, ha), (b, hb) = read_image(dirs[0] / name), read_image(dirs[1] / name)
        assert a.shape == b.shape and dict(ha) == dict(hb)
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    print(f"image logger ({'with' if label else 'without'} labels): {len(names[0]) - 1} FITS, "
          f"max|port - JAX| / max|JAX| {worst:.3e} (rtol 1e-6)")


def _ssim_map_f64(pred, target):
    """The SSIM map evaluated in float64 (the same reflect pad, separable
    13-tap Gaussian and constants)."""
    import torch.nn.functional as F

    from xmm_superres_denoise_torch.ops.ssim import gaussian_kernel_1d

    taps = torch.as_tensor(gaussian_kernel_1d(), dtype=torch.float64)

    def blur(x):
        return F.conv2d(F.conv2d(x, taps.reshape(1, 1, 13, 1)), taps.reshape(1, 1, 1, 13))

    p, t = (F.pad(torch.as_tensor(a, dtype=torch.float64).permute(0, 3, 1, 2), (6,) * 4,
                  mode="reflect") for a in (pred, target))
    mu_p, mu_t = blur(p), blur(t)
    s_p, s_t, s_pt = blur(p * p) - mu_p**2, blur(t * t) - mu_t**2, blur(p * t) - mu_p * mu_t
    c1, c2 = 0.01**2, 0.05**2
    m = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / ((mu_p**2 + mu_t**2 + c1) * (s_p + s_t + c2))
    return m[0, 0].numpy()


def test_ssim_map_matches_jax():
    """Each f32 map sums its blurs in its own order, and the variances
    cancel (about ten f32 ulps at 1): the port's map and JAX's are each held
    within 2e-6 of a float64 evaluation."""
    lr, preds, hr = _display_arrays(seed=4, b=1, res=24)
    got = til._ssim_map(preds, hr)
    want = np.asarray(jil._ssim_map(preds, hr))
    exact = _ssim_map_f64(preds, hr)
    print(f"SSIM map {got.shape}: max|port - float64| {np.abs(got - exact).max():.3e}, "
          f"max|JAX - float64| {np.abs(want - exact).max():.3e} (atol 2e-6 each), "
          f"max|port - JAX| {np.abs(got - want).max():.3e}")
    assert got.shape == want.shape == (48, 48)
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-6)
    np.testing.assert_allclose(want, exact, rtol=0, atol=2e-6)


def test_image_logger_epoch_gating_and_no_matplotlib(tmp_path, monkeypatch, caplog):
    lr, preds, hr = _display_arrays()
    port, jax = _loggers(tmp_path, every=2)
    assert [port.should_log(e) for e in range(5)] == [jax.should_log(e) for e in range(5)] == [
        True, False, True, False, True]
    assert port.log_batch(1, lr, preds, hr) is None and not (tmp_path / "port").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # no matplotlib: FITS only
    with caplog.at_level(logging.WARNING, logger="xmmsr"):
        assert port.log_batch(4, lr, preds, hr) is None
    assert "matplotlib is not installed" in caplog.text
    assert sorted(p.name for p in (tmp_path / "port/epoch_00004").iterdir()) == sorted(
        f"display_{i}_{k}.fits.gz" for i in range(3) for k in ("generated", "input"))


def test_fit_logs_images_as_the_jax_trainer(tmp_path, monkeypatch):
    """One epoch with `log_images_every_n_epochs = 1` in both trainers from
    JAX's init: the same image files, the inputs equal, the generated
    images at the f32 class."""
    pytest.importorskip("matplotlib")
    loss = dict(metric_names=["l1"])
    ds, mc, tc = configs(jcfg, tmp_path / "jax", epochs=1, log_images_every_n_epochs=1)
    jdmod = jdm.XmmDataModule(ds, splits_root=tmp_path / "jax/splits", boring_size=16)
    jloss = jtrain.create_loss(SQRT_TABLE, jcfg.LossCfg(**LOSS_WEIGHTS))
    jtr = jtrain.Trainer(mc, tc, jdmod, jloss, mesh=jmesh.make_mesh(data=1, fsdp=1), **loss)
    jparams = jtr.init_state(0).params
    jtr.fit(seed=0)

    ds, mc, tc = configs(tcfg, tmp_path / "port", epochs=1, log_images_every_n_epochs=1)
    dm = XmmDataModule(ds, splits_root=tmp_path / "port/splits", boring_size=16, device="cpu")
    tr = Trainer(mc, tc, dm, create_loss(SQRT_TABLE, tcfg.LossCfg(**LOSS_WEIGHTS)), device="cpu",
                 **loss)
    start = state_dict_of(jparams)
    init = tr.init_state
    monkeypatch.setattr(tr, "init_state", lambda seed=0, params=None: init(seed, params or start))
    tr.fit(seed=0)

    dirs = [tmp_path / k / "ckpt/esr_gen/images/epoch_00000" for k in ("port", "jax")]
    names = [sorted(p.name for p in d.iterdir()) for d in dirs]
    assert names[0] == names[1] and "display.png" in names[0] and len(names[0]) > 2
    worst = {}
    for name in names[0]:
        if name.endswith(".fits.gz"):
            a, b = read_image(dirs[0] / name)[0], read_image(dirs[1] / name)[0]
            kind = name.split("_")[-1].split(".")[0]
            scale = (LR_MAX * 20e3) if kind == "input" else (SR_HR_MAX * 100e3)
            worst[kind] = max(worst.get(kind, 0.0), float(np.abs(a - b).max() / scale))
    print(f"fit image files {names[0]}; max|port - JAX| / (clamp_max x exposure): {worst} "
          f"(input 1e-6, generated 1e-5)")
    assert worst["input"] <= 1e-6 and worst["generated"] <= 1e-5


def test_flops_estimate_counts_two_per_multiply_add():
    convs = torch.nn.Sequential(torch.nn.Conv2d(1, 8, 3, padding=1), torch.nn.ReLU(),
                                torch.nn.Conv2d(8, 4, 3, padding=1))
    x = torch.zeros(2, 1, 16, 16)
    analytic = 2 * 2 * 16 * 16 * 9 * (1 * 8 + 8 * 4)
    got = tprof.flops_estimate(convs, x)

    import jax
    import jax.numpy as jnp

    w1, w2 = jnp.zeros((3, 3, 1, 8)), jnp.zeros((3, 3, 8, 4))

    def jconvs(x):
        dn = ("NHWC", "HWIO", "NHWC")
        y = jax.lax.conv_general_dilated(x, w1, (1, 1), "SAME", dimension_numbers=dn)
        return jax.lax.conv_general_dilated(jax.nn.relu(y), w2, (1, 1), "SAME",
                                            dimension_numbers=dn)

    jax_flops = jprof.flops_estimate(jconvs, jnp.zeros((2, 16, 16, 1)))
    print(f"flops_estimate: port {got}, analytic 2 x MAC {analytic}, JAX's XLA cost analysis "
          f"{jax_flops} (XLA's own count, not held equal)")
    assert got == analytic
    assert tprof.flops_estimate(lambda: 1 / 0) is None


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with tprof.trace(tmp_path / "prof"):
        with tprof.annotate("xmmsr_region"):
            torch.ones(64).add_(1).sum()
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    print(f"trace {path.name}: {path.stat().st_size} bytes, {len(events)} events")
    assert any(e.get("name") == "xmmsr_region" for e in events)


@pytest.mark.parametrize("steps", [None, 2, 5])
def test_trace_window_holds_the_first_steps(tmp_path, steps):
    """`trace(dir, steps=N)` records from its start to the N-th `step()`
    and writes the trace there; a loop that ends first is written on exit,
    and `steps=None` records the whole region."""
    written = []
    with tprof.trace(tmp_path, steps=steps) as step:
        for i in range(4):
            with tprof.annotate(f"xmmsr_step_{i}"):
                torch.ones(64).add_(1).sum()
            step()
            written.append(len(list(tmp_path.glob("*.pt.trace.json"))))
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    traced = [i for i in range(4) if f"xmmsr_step_{i}" in names]
    print(f"steps={steps}: steps traced {traced}, trace written after step {written}")
    n = 4 if steps is None else min(steps, 4)
    assert traced == list(range(n))
    assert written == [int(steps is not None and i + 1 >= steps) for i in range(4)]


@pytest.mark.parametrize("rank", [0, 1])
def test_setup_logging_is_rank_aware(rank):
    logger = logging.getLogger("xmmsr")
    level, handlers = logger.level, list(logger.handlers)
    try:
        logger.handlers = []
        got = tlog.setup_logging(logging.INFO, process_index=rank)
        got_level = got.level
        logger.handlers = []
        want = jlog.setup_logging(logging.INFO, process_index=rank)
        assert got is want and got_level == want.level == (
            logging.INFO if rank == 0 else logging.WARNING)
        logger.handlers = []
        assert tlog.setup_logging(logging.DEBUG).level == logging.DEBUG  # no group: rank 0
        assert len(logger.handlers) == 1
    finally:
        logger.handlers = handlers
        logger.setLevel(level)


def test_build_cache_directory_policy(tmp_path, monkeypatch):
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    assert jitcache.default_cache_dir(checkout) == checkout / "build/torch_kernels"
    home_cache = Path.home() / ".cache" / "xmmsr_torch_kernels"
    installed = tmp_path / "lib/python3.12/site-packages"
    installed.mkdir(parents=True)
    assert jitcache.default_cache_dir(installed) == home_cache
    monkeypatch.setattr(jitcache.os, "access", lambda path, mode: False)  # a read-only checkout
    assert jitcache.default_cache_dir(checkout) == home_cache
    monkeypatch.undo()
    assert cuda_build.BUILD_DIR == ROOT / "build/torch_kernels"  # this checkout is writable
