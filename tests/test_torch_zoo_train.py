"""Configs, full-width builds and training of the transformer zoo, on the CPU.

* The five shipped zoo run configs (`res/configs/runs/{swinir_sr,
  swinfir_sr, drct_sr_fsdp, hat_sr, restormer_denoise}.toml`) load like the
  JAX CLI's, and the registry builds each at full width: every Flax-layout
  array of the port's model (`layers_scan` for HAT and DRCT, whose run
  configs set `scan_layers`) has the shape of JAX's, from
  `jax.eval_shape` of its init at 416^2.
* One train step of a tiny SwinIR (embed 12, depths (2, 2), 24^2 -> 48^2,
  JAX's init) against JAX's `make_train_step` on a one-device mesh: the
  loss to 1e-6 relative, every gradient to 1e-5 x max|g| of its leaf, and
  the parameters after the Adam step to 1e-3 x lr (entries with |g| < 1e-6
  left out, as in `test_torch_train_step.py`).
* `memory_efficient` (a checkpoint per transformer block) is bitwise the
  plain forward and gradient, for SwinIR, DRCT and HAT.
* What JAX refuses, the port refuses: `s2d_train` and int8 serving of a
  transformer, DRCT and HAT with another upsampler, `scan_layers` over
  non-uniform stacks.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import LOSS_WEIGHTS, SQRT_TABLE, batch, configs, to_torch
from _torch_zoo_common import jax_init, port

from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch import config as tcfg
from xmm_superres_denoise_torch.config.schema import LossCfg as TLossCfg
from xmm_superres_denoise_torch.data.datamodule import XmmDataModule
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.models import drct as tdrct
from xmm_superres_denoise_torch.models import hat as thaat
from xmm_superres_denoise_torch.models import swinir as tswinir
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.train import loss as tl
from xmm_superres_denoise_torch.train import steps as ts
from xmm_superres_denoise_torch.train.loop import Trainer
from xmm_superres_denoise_torch.utils.weights import flax_tree, params_from_flax

ROOT = Path(__file__).resolve().parents[1]
jcli = importlib.import_module("xmm_superres_denoise_tpu.cli")
jregistry = importlib.import_module("xmm_superres_denoise_tpu.models.registry")
jzoo = importlib.import_module("xmm_superres_denoise_tpu.models")
jl = importlib.import_module("xmm_superres_denoise_tpu.train.loss")
jcfg = importlib.import_module("xmm_superres_denoise_tpu.config.schema")
jsteps = importlib.import_module("xmm_superres_denoise_tpu.train.steps")
jmesh = importlib.import_module("xmm_superres_denoise_tpu.parallel.mesh")

ZOO_RUNS = ("swinir_sr", "swinfir_sr", "drct_sr_fsdp", "hat_sr", "restormer_denoise")
SWIN = dict(img_size=24, patch_size=8, in_chans=1, embed_dim=12, depths=(2, 2),
            num_heads=(2, 2), window_size=8, mlp_ratio=2.0, upscale=2,
            upsampler="pixelshuffle", num_feat=8)
LR = 2e-4  # the zoo's learning rate (res/configs/models.toml)
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, TINY_G = 1e-6, 1e-5, 1e-3 * LR, 1e-6


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("run", ZOO_RUNS)
def test_run_config_builds_at_full_width_with_jax_shapes(run):
    path = ROOT / "res/configs/runs" / f"{run}.toml"
    ds, mc, tc, _, _ = tcli.load_run_config(path)
    jds, jmc, jtc, _, _ = jcli.load_run_config(path)
    assert mc.name.value == jmc.name.value and mc.scan_layers == jmc.scan_layers
    assert mc.memory_efficient == jmc.memory_efficient and tc.mesh.fsdp == jtc.mesh.fsdp
    for field in ("base_model", "in_channels", "img_size", "patch_size", "window_size",
                  "embed_dim", "upsampler", "num_heads", "depths", "dim", "out_channels"):
        if hasattr(jmc.model, field):
            assert getattr(mc.model, field) == getattr(jmc.model, field), field
    assert mc.optimizer.learning_rate == jmc.optimizer.learning_rate
    lr, hr = (ds.lr.res,) * 2, (ds.hr.res,) * 2
    model = build_model(mc, lr, hr)
    got = _shapes(flax_tree(model.state_dict(), scan_layers=mc.scan_layers))
    jmodel = jregistry.build_model(jmc, lr, hr)
    want = _shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                  jax.ShapeDtypeStruct((1, *lr, 1), jnp.float32))["params"])
    n = sum(int(np.prod(s)) for s in want.values())
    print(f"{run}: {type(model).__name__}, {len(want)} Flax arrays, {n} parameters, "
          f"scan_layers {mc.scan_layers}, memory_efficient {mc.memory_efficient}")
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == n


@pytest.fixture(scope="module")
def swinir():
    jmodel = jzoo.SwinIR(**SWIN)
    x = np.zeros((1, 24, 24, 1), np.float32)
    return jmodel, jax_init(jmodel, x)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_swinir_train_step_matches_jax(swinir):
    jmodel, v = swinir
    b = batch(seed=0, b=2, lr_res=24)
    jloss = jl.create_loss(SQRT_TABLE, jcfg.LossCfg(**LOSS_WEIGHTS))
    tloss = tl.create_loss(SQRT_TABLE, TLossCfg(**LOSS_WEIGHTS))
    mesh = jmesh.make_mesh(data=1, fsdp=1)
    japply = lambda p, x: jnp.clip(jmodel.apply(p, x), 0.0, 1.0)  # noqa: E731
    jtx = optax.adam(LR, b1=0.9, b2=0.999)
    jb = {k: jnp.asarray(a) for k, a in b.items()}
    jgrad, _ = jsteps.make_accum_steps(japply, jloss, jtx, mesh=mesh, donate=False)
    gsum, jlsum, jwsum = jgrad(v, jb)
    jg = params_from_flax(jax.tree_util.tree_map(lambda g: np.asarray(g / jwsum),
                                                 gsum["params"]), tswinir.SwinIR(**SWIN))
    jstate, _ = jsteps.make_train_step(japply, jloss, jtx, mesh, donate=False)(
        jsteps.TrainState.create(v, jtx), jb)
    jparams = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params["params"]),
                               tswinir.SwinIR(**SWIN))

    tx = ts.Tx(LR)
    state = ts.TrainState.create(port(tswinir.SwinIR(**SWIN), v), tx)
    lsum, wsum = ts.make_accum_steps(ts.clamped_apply, tloss, tx)[0](state, to_torch(b))
    grads = {n: g / wsum for n, g in _grads(state.module).items()}
    loss_err = abs(float(lsum / wsum) - float(jlsum / jwsum)) / abs(float(jlsum / jwsum))
    g_worst = max(float((grads[n] - jg[n]).abs().max()) / max(float(jg[n].abs().max()), 1e-30)
                  for n in jg)
    moved = sum(int((jg[n].abs() > 0).any()) for n in jg)

    state = ts.TrainState.create(port(tswinir.SwinIR(**SWIN), v), tx)
    state, _ = ts.make_train_step(ts.clamped_apply, tloss, tx)(state, to_torch(b))
    p_worst, left_out = 0.0, 0
    for n, p in state.module.named_parameters():
        keep = jg[n].abs() >= TINY_G
        left_out += int((~keep).sum())
        d = (p.detach() - jparams[n]).abs()[keep]
        p_worst = max(p_worst, float(d.max()) if d.numel() else 0.0)
    print(f"SwinIR step: loss rel diff {loss_err:.2e} (tol {LOSS_RTOL:.0e}); gradients largest "
          f"max|diff|/max|g| {g_worst:.2e} (tol {GRAD_RTOL:.0e}), {moved} of {len(jg)} leaves "
          f"with a gradient; parameters after the Adam step max|diff| {p_worst:.2e} (tol "
          f"{PARAM_ATOL:.0e}), {left_out} entries with |g| < {TINY_G:.0e} left out")
    assert loss_err <= LOSS_RTOL and g_worst <= GRAD_RTOL and p_worst <= PARAM_ATOL
    assert moved == len(jg) and state.step == 1


MEMORY_CASES = {
    "swinir": lambda me: tswinir.SwinIR(**SWIN, use_checkpoint=me),
    "drct": lambda me: tdrct.DRCT(**dict(SWIN, depths=(1,), num_heads=(2,), gc=6),
                                  use_checkpoint=me),
    "hat": lambda me: thaat.HAT(img_size=24, patch_size=1, in_chans=1, embed_dim=12,
                                depths=(2,), num_heads=(2,), window_size=6, mlp_ratio=2.0,
                                squeeze_factor=4, num_feat=8, overlap_ratio=1 / 3,
                                use_checkpoint=me),
}


@pytest.mark.parametrize("name", list(MEMORY_CASES))
def test_memory_efficient_is_bitwise_the_plain_forward_and_gradient(name):
    plain, remat = MEMORY_CASES[name](False), MEMORY_CASES[name](True)
    plain.reset_parameters(torch.Generator().manual_seed(3))
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(batch(seed=1, b=2, lr_res=24)["lr"])
    outs = []
    for m in (plain, remat):
        y = m(x)
        (y * y).mean().backward()
        outs.append((y.detach(), _grads(m)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][n], outs[1][1][n]) for n in outs[0][1])
    print(f"{name}: memory_efficient forward and {len(outs[0][1])} gradients bitwise equal")


def test_zoo_refusals_follow_jax(tmp_path):
    ds, _, tc = configs(tcfg, tmp_path, lr_res=24)
    mc = tcfg.ModelCfg(name="swinir", s2d_train=True, model=dict(
        base_model="swinir", img_size=24, patch_size=8, window_size=8, embed_dim=12,
        num_heads=[2], depths=[1]), optimizer=tcfg.OptimizerCfg(learning_rate=LR))
    dm = XmmDataModule(ds, splits_root=tmp_path / "splits", boring_size=8, device="cpu")
    with pytest.raises(ValueError, match="RRDB models only"):
        Trainer(mc, tc, dm, tl.create_loss(None, TLossCfg(l1=1.0)), device="cpu")
    mc.s2d_train = False
    state = build_model(mc, (24, 24), (48, 48)).state_dict()
    with pytest.raises(ValueError, match="RRDB models only"):
        InferenceEngine(mc, ds, state, quantize=True, device="cpu")
    for name in ("drct", "hat"):
        bad = tcfg.ModelCfg(name=name, model=dict(mc.model.__dict__, base_model=name,
                                                  upsampler=""))
        with pytest.raises(ValueError, match="pixelshuffle"):
            build_model(bad, (24, 24), (48, 48))
    with pytest.raises(ValueError, match="uniform"):
        tswinir.SwinIR(**dict(SWIN, depths=(2, 1)), scan_layers=True)
