"""The port's SSIM, metrics, composite loss and config schema against the JAX
package's, on the CPU, on the same numpy inputs made from a seed.

Tolerances (f32): values within 1e-5 relative of JAX's (the two libraries
sum the depthwise blurs and the means in other orders); gradients within
1e-5 x max|grad| of `jax.grad`'s. Each test prints the max|diff| it measured.

Sizes: SSIM and the metrics that do not need MS-SSIM run at 64^2 or below.
MS-SSIM needs 13 * 16 = 208 px per side (five halving scales), so it and
the run configs' loss (psnr 0.5 + ms_ssim 0.5) run at (1, 208, 208, 1): the
one exception to the fast suite's 64^2 rule.
"""

import dataclasses
import enum
import importlib
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.metrics import functional as tm
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.ops import ssim as ts
from xmm_superres_denoise_torch.train import loss as tl
from xmm_superres_denoise_tpu import cli as jcli
from xmm_superres_denoise_tpu.config import schema as jcfg
from xmm_superres_denoise_tpu.train import loss as jl

# the JAX metrics package re-exports functions named like its modules
jm = importlib.import_module("xmm_superres_denoise_tpu.metrics.functional")
js = importlib.import_module("xmm_superres_denoise_tpu.ops.ssim")

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
GRAD_RTOL = 1e-5
MS_SHAPE = (1, 208, 208, 1)
STRETCHES = ["linear", "sqrt", "asinh", "log", None]  # None: use_scaling = false
with open(ROOT / "res/configs/loss_functions.toml", "rb") as _f:
    LOSS_TOML = tomllib.load(_f)


def _pair(shape, seed=0):
    """A smooth positive target in [0, 1] and a noisy prediction of it."""
    g = np.random.default_rng(seed)
    coarse = g.uniform(0, 1, (shape[0], shape[1] // 8 + 1, shape[2] // 8 + 1, shape[3]))
    target = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, : shape[1], : shape[2]]
    target = np.clip(target + 0.05 * g.normal(size=shape), 0.0, 1.0)
    preds = np.clip(target + 0.1 * g.normal(size=shape), 1e-3, 1.0)
    return preds.astype(np.float32), target.astype(np.float32)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    print(f"{what}: max|diff| {err:.3e}, {err / scale:.3e} relative (tol {rtol:.0e})")
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _value_and_grad(jax_fn, torch_fn, preds, target):
    jv, jg = jax.value_and_grad(lambda p: jax_fn(p, jnp.asarray(target)))(jnp.asarray(preds))
    x = torch.from_numpy(preds).requires_grad_()
    tv = torch_fn(x, torch.from_numpy(target))
    tv.backward()
    return (float(tv.detach()), x.grad.numpy()), (float(jv), np.asarray(jg))


def test_gaussian_taps_match_jax():
    np.testing.assert_array_equal(ts.gaussian_kernel_1d(), js.gaussian_kernel_1d())
    np.testing.assert_array_equal(ts.gaussian_kernel_1d(7, 1.5), js.gaussian_kernel_1d(7, 1.5))


@pytest.mark.parametrize("return_cs", [False, True], ids=["ssim", "ssim+cs"])
def test_ssim_per_image_matches_jax(return_cs):
    preds, target = _pair((2, 48, 40, 2), seed=1)
    got = ts.ssim_per_image(torch.from_numpy(preds), torch.from_numpy(target), return_cs=return_cs)
    want = js.ssim_per_image(jnp.asarray(preds), jnp.asarray(target), return_cs=return_cs)
    got = got if return_cs else (got,)
    want = want if return_cs else (want,)
    for name, g, w in zip(("ssim", "cs"), got, want):
        assert g.shape == (2,)
        _close(g.numpy(), w, RTOL, name)


def test_ms_ssim_per_image_matches_jax():
    preds, target = _pair(MS_SHAPE, seed=2)
    got = ts.ms_ssim_per_image(torch.from_numpy(preds), torch.from_numpy(target))
    _close(got.numpy(), js.ms_ssim_per_image(jnp.asarray(preds), jnp.asarray(target)), RTOL,
           "ms_ssim")


def test_ms_ssim_refuses_images_under_208_px():
    x = torch.zeros(1, 207, 208, 1)
    with pytest.raises(ValueError, match="needs images >= 208 px"):
        ts.ms_ssim_per_image(x, x)


def test_ms_ssim_gradient_where_contrast_is_not_positive_matches_jax():
    """An anti-correlated prediction makes the contrast terms negative: the
    ReLU gives a zero base under a fractional exponent. jax.grad gives 0
    there, and so must autograd (no NaN, no epsilon)."""
    _, target = _pair(MS_SHAPE, seed=3)
    preds = 1.0 - target
    (tv, tg), (jv, jg) = _value_and_grad(
        lambda p, t: jnp.mean(js.ms_ssim_per_image(p, t)),
        lambda p, t: ts.ms_ssim_per_image(p, t).mean(), preds, target)
    print(f"value port {tv} JAX {jv}; max|grad| port {np.abs(tg).max()} JAX {np.abs(jg).max()}")
    assert tv == jv == 0.0
    assert np.isfinite(tg).all() and np.isfinite(jg).all()
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("name", sorted(tm.CORE_METRICS))
def test_core_metric_and_gradient_match_jax(name):
    shape = MS_SHAPE if name == "ms_ssim" else (2, 64, 64, 1)
    preds, target = _pair(shape, seed=4)
    (tv, tg), (jv, jg) = _value_and_grad(jm.CORE_METRICS[name], tm.CORE_METRICS[name],
                                         preds, target)
    _close(tv, jv, RTOL, f"{name} value")
    _close(tg, jg, GRAD_RTOL, f"{name} gradient")


def _loss_cfgs(stretch, every_term):
    loss = dict(LOSS_TOML["loss"])
    if every_term:
        loss.update(l1=0.2, poisson=0.2, psnr=0.2, ssim=0.2, ms_ssim=0.2)
    loss["use_scaling"] = stretch is not None
    toml = {"loss": loss, "scaling": LOSS_TOML["scaling"]}
    return tl.load_scaling_tables(toml, stretch or "sqrt"), jl.load_scaling_tables(toml, stretch or "sqrt")


@pytest.mark.parametrize("every_term", [False, True], ids=["run-config-terms", "all-five-terms"])
@pytest.mark.parametrize("stretch", STRETCHES, ids=[s or "no-scaling" for s in STRETCHES])
def test_create_loss_value_and_gradient_match_jax(stretch, every_term):
    (t_sc, t_cfg), (j_sc, j_cfg) = _loss_cfgs(stretch, every_term)
    assert t_sc == j_sc
    t_loss, j_loss = tl.create_loss(t_sc, t_cfg), jl.create_loss(j_sc, j_cfg)
    assert [(n, p) for n, p, _ in t_loss.terms] == [(n, p) for n, p, _ in j_loss.terms]
    assert t_loss.correction == j_loss.correction
    preds, target = _pair(MS_SHAPE, seed=5)
    (tv, tg), (jv, jg) = _value_and_grad(j_loss, t_loss, preds, target)
    _close(tv, jv, RTOL, f"loss[{stretch}] value")
    _close(tg, jg, GRAD_RTOL, f"loss[{stretch}] gradient")


def test_create_loss_drops_zero_terms_and_keeps_only_a_positive_correction():
    sc = LOSS_TOML["scaling"]["linear"]  # psnr's correction > 0, l1's < 0
    for cfg in (dict(l1=1.0), dict(psnr=0.5, l1=0.5), dict(ms_ssim=1.0)):
        t_loss = tl.create_loss(sc, tcfg.LossCfg(**cfg))
        j_loss = jl.create_loss(sc, jcfg.LossCfg(**cfg))
        names = [n for n, *_ in t_loss.terms]
        assert names == [n for n, *_ in j_loss.terms]
        assert sorted(names) == sorted(cfg)  # no term of weight 0
        assert t_loss.correction == j_loss.correction >= 0.0
    assert tl.create_loss(sc, tcfg.LossCfg(l1=1.0)).correction == 0.0  # l1's is negative


@pytest.mark.parametrize("weights", [
    dict(l1=1.5), dict(psnr=-0.1, ms_ssim=0.5), dict(), dict(psnr=0.6, ms_ssim=0.6),
], ids=["weight>1", "weight<0", "sum=0", "sum>1"])
def test_loss_cfg_refuses_what_jax_refuses(weights):
    with pytest.raises(Exception) as jax_err:
        jcfg.LossCfg(**weights)
    with pytest.raises(tcfg.ConfigError) as port_err:
        tcfg.LossCfg(**weights)
    print(f"JAX: {jax_err.value!s:.120}; port: {port_err.value}")
    if isinstance(jax_err.value, jcfg.ConfigError):  # the sum rule: JAX's own message
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("precision", ["32", 32, "32-true", "fp32", "f32", "bf16-mixed",
                                       "bf16-true", "bf16"])
def test_trainer_cfg_normalises_precision_like_jax(precision):
    assert tcfg.TrainerCfg(precision=precision).precision == jcfg.TrainerCfg(
        precision=precision).precision


def test_trainer_cfg_legacy_strategy_checkpoints_and_refusals():
    for kw in (dict(strategy="fsdp"), dict(strategy="fsdp", mesh={"fsdp": 4}),
               dict(strategy="ddp"), dict(mesh={"data": 2, "remat": True})):
        t, j = tcfg.TrainerCfg(**kw), jcfg.TrainerCfg(**kw)
        assert (t.mesh.data, t.mesh.fsdp, t.mesh.remat) == (j.mesh.data, j.mesh.fsdp, j.mesh.remat)
    t = tcfg.TrainerCfg(checkpoint_path="", checkpoint_root="ckpts")
    assert t.checkpoint_path is None and t.checkpoint_root == Path("ckpts")
    for bad in (dict(precision="f16"), dict(epochs=0), dict(accelerator="gpu"),
                dict(strategy="deepspeed"), dict(mesh={"fsdp": 0}), dict(gradient_clip_val=-1.0)):
        with pytest.raises(Exception):
            jcfg.TrainerCfg(**bad)
        with pytest.raises(tcfg.ConfigError):
            tcfg.TrainerCfg(**bad)
    with pytest.raises(TypeError):  # an undeclared key is refused, not dropped
        tcfg.TrainerCfg(epoch=3)


def _plain(value):
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return tuple(_plain(v) for v in value)
    return value


def _same_config(port, ref, where):
    """Every field of a port dataclass equals the JAX model's field."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _same_config(got, want, f"{where}.{f.name}")
        else:
            assert _plain(got) == _plain(want), f"{where}.{f.name}: {got!r} != {want!r}"


RRDB_RUNS = sorted(
    p.name for p in (ROOT / "res/configs/runs").glob("*.toml")
    if tomllib.loads(p.read_text())["model"]["name"] in ("esr_gen", "rrdb_denoise")
)


@pytest.mark.parametrize("run", RRDB_RUNS)
def test_load_run_config_five_parts_match_jax(run):
    path = ROOT / "res/configs/runs" / run
    ds, mc, tc, sc, lc = tcli.load_run_config(path)
    jds, jmc, jtc, jsc, jlc = jcli.load_run_config(path)
    for port, ref, name in ((ds, jds, "dataset"), (mc, jmc, "model"), (tc, jtc, "trainer"),
                            (lc, jlc, "loss")):
        _same_config(port, ref, name)
    assert sc == jsc
    assert tcfg.load_run_config(path) == (ds, mc)  # the two-part loader is unchanged


def test_mesh_remat_forces_memory_efficient_which_the_registry_refuses(tmp_path):
    text = (ROOT / "res/configs/runs/esr_gen_sr.toml").read_text()
    path = tmp_path / "remat.toml"
    path.write_text(text.replace("[trainer.mesh]", "[trainer.mesh]\nremat = true"))
    _, mc, tc, _, _ = tcli.load_run_config(path)
    _, jmc, _, _, _ = jcli.load_run_config(path)
    assert tc.mesh.remat and mc.memory_efficient is jmc.memory_efficient is True
    # the registry refused memory_efficient until the training harness came;
    # it now builds the model with each RRDB checkpointed
    assert build_model(mc, (32, 32), (64, 64)).trunk.memory_efficient is True
