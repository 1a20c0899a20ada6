"""The port's eval step against the JAX package's `make_eval_step`, on the CPU.

The same esr_gen generator (8 filters, 1 RRDB, seeded Flax init copied into
the port), the run config's loss (psnr 0.5 + ms_ssim 0.5, sqrt table), and
the trainer's four collections (core, extended and the `in:` input-baseline
twin of each) for the linear and sqrt scaling normalizers, on a batch of 3
samples plus one padded row (weight 0), with `upsample_input = 2`. JAX's
step runs on a 1-device CPU mesh. The states, the loss sum and the weight
sum must be within 1e-5 relative of JAX's. MS-SSIM (in the loss and the
core metrics) needs 208 px per side, so the batch is 104^2 -> 208^2, the
one exception to the fast suite's 64^2 rule. Each test prints the max
relative difference it measured.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.config.schema import LossCfg
from xmm_superres_denoise_torch.metrics import collection as tcoll
from xmm_superres_denoise_torch.metrics import extended as te
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops.stretch import Normalizer as TNorm
from xmm_superres_denoise_torch.train import loss as tl
from xmm_superres_denoise_torch.train.steps import clamped_apply, make_eval_step
from xmm_superres_denoise_torch.utils.weights import params_from_flax

jcli = importlib.import_module("xmm_superres_denoise_tpu.cli")
jcoll = importlib.import_module("xmm_superres_denoise_tpu.metrics.collection")
jext = importlib.import_module("xmm_superres_denoise_tpu.metrics.extended")
jrrdb = importlib.import_module("xmm_superres_denoise_tpu.models.rrdb")
jloss = importlib.import_module("xmm_superres_denoise_tpu.train.loss")
jsteps = importlib.import_module("xmm_superres_denoise_tpu.train.steps")
jloop = importlib.import_module("xmm_superres_denoise_tpu.train.loop")
jmesh = importlib.import_module("xmm_superres_denoise_tpu.parallel.mesh")
JNorm = importlib.import_module("xmm_superres_denoise_tpu.ops.stretch").Normalizer

ROOT = Path(__file__).resolve().parents[1]
RUN_CONFIG = ROOT / "res/configs/runs/esr_gen_sr.toml"
RTOL = 1e-5
LR, SCALE, FILTERS, BLOCKS = 104, 2, 8, 1
MODES = ("linear", "sqrt")


def _batch(seed=0):
    """3 samples and a padded copy of the last, weights (1, 1, 1, 0): a
    smooth sqrt-stretched scene at LR, and its HR counterpart with noise."""
    g = np.random.default_rng(seed)
    coarse = g.uniform(0.05, 0.9, (3, LR // 8, LR // 8, 1))
    hr = np.repeat(np.repeat(coarse, 8 * SCALE, axis=1), 8 * SCALE, axis=2)
    hr = np.clip(hr + 0.03 * g.normal(size=hr.shape), 0, 1)
    lr = np.clip(hr[:, ::SCALE, ::SCALE] + 0.05 * g.normal(size=(3, LR, LR, 1)), 0, 1)
    lr, hr = (np.concatenate([a, a[-1:]]).astype(np.float32) for a in (lr, hr))
    return lr, hr, np.array([1, 1, 1, 0], np.float32)


def _collections(mod, norm):
    ext_names = te.EXT_METRIC_NAMES
    ds = norm(0.0022336, 0.0005584, "sqrt")
    scalers = [norm(0.0022336, 0.0005584, m) for m in MODES]
    return {
        "metrics": mod.XMMMetricCollection(ds, scalers, "val"),
        "in:metrics": mod.XMMMetricCollection(ds, scalers, "val", input_baseline=True),
        "ext": mod.XMMMetricCollection(ds, scalers, "val", metric_names=ext_names),
        "in:ext": mod.XMMMetricCollection(ds, scalers, "val", metric_names=ext_names,
                                          input_baseline=True),
    }


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_eval_step_matches_jax():
    assert jext.EXT_METRIC_NAMES == te.EXT_METRIC_NAMES
    lr, hr, w = _batch()

    # JAX: a seeded Flax init, its eval step on a 1-device mesh
    jmodel = jrrdb.GeneratorRRDB_SR(num_filters=FILTERS, num_res_blocks=BLOCKS)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, LR, LR, 1)))
    _, _, _, j_sc, j_lcfg = jcli.load_run_config(RUN_CONFIG)
    jl = jloss.create_loss(j_sc, j_lcfg)
    jcolls = _collections(jcoll, JNorm)
    jstep = jsteps.make_eval_step(
        lambda p, x: jloop.clamped_apply(jmodel, p, x), jl,
        jmesh.make_mesh(data=1, fsdp=1, devices=jax.devices()[:1]),
        metric_updaters={k: c.update for k, c in jcolls.items()}, upsample_input=SCALE,
    )
    jstates, jloss_sum, jw_sum = jstep(
        params, {k: c.init() for k, c in jcolls.items()},
        {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr), "weight": jnp.asarray(w)},
    )

    # the port: the same weights, its eval step on the CPU
    model = GeneratorRRDB_SR(num_filters=FILTERS, num_res_blocks=BLOCKS)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    _, _, _, t_sc, t_lcfg = tcli.load_run_config(RUN_CONFIG)
    tcolls = _collections(tcoll, TNorm)
    step = make_eval_step(
        lambda x: clamped_apply(model, x), tl.create_loss(t_sc, t_lcfg),
        metric_updaters={k: c.update for k, c in tcolls.items()}, upsample_input=SCALE,
    )
    states, loss_sum, w_sum = step(
        {k: c.init("cpu") for k, c in tcolls.items()},
        {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr), "weight": torch.from_numpy(w)},
    )

    assert float(w_sum) == float(jw_sum) == 3.0
    worst = _rel(float(loss_sum), float(jloss_sum))
    print(f"loss sum {float(loss_sum):.8f} vs JAX {float(jloss_sum):.8f}, rel {worst:.3e}")
    assert worst <= RTOL
    n = 0
    for key, coll in tcolls.items():
        ours, ref = coll.compute(states[key]), jcolls[key].compute(jstates[key])
        assert sorted(ours) == sorted(ref)
        for mode in MODES:
            for name, (s, c) in states[key][mode].items():
                js, jc = jstates[key][mode][name]
                for a, b in ((s, js), (c, jc)):
                    err = _rel(float(a), float(b))
                    worst = max(worst, err)
                    assert err <= RTOL, (key, name, float(a), float(b))
                n += 1
        for name in ref:
            assert np.isfinite(float(ours[name]))
    print(f"{n} (sum, count) states over {len(tcolls)} collections, max relative diff "
          f"{worst:.3e} (tol {RTOL:.0e})")


@pytest.mark.parametrize("last_weight", [0.0, 1.0])
def test_padded_row_adds_nothing(last_weight):
    """The step on 3 rows plus a copy of the last at weight 0 equals the
    step on the 3 rows (loss sum, weight sum and every state); at weight 1
    the copy counts."""
    lr, hr, _ = _batch(seed=1)
    torch.manual_seed(0)
    model = GeneratorRRDB_SR(num_filters=4, num_res_blocks=1)
    coll = tcoll.XMMMetricCollection(
        TNorm(0.0022336, 0.0005584, "sqrt"), [TNorm(0.0022336, 0.0005584, "linear")], "val",
        metric_names=("psnr", "l1", "poisson"))
    loss = tl.create_loss(None, LossCfg(l1=1.0, poisson=0.0, psnr=0.0, ssim=0.0, ms_ssim=0.0))
    step = make_eval_step(lambda x: clamped_apply(model, x), loss,
                          {"m": coll.update, "in:m": coll.update}, upsample_input=SCALE)

    def run(n, weight=None):
        batch = {"lr": torch.from_numpy(lr[:n]), "hr": torch.from_numpy(hr[:n])}
        if weight is not None:
            batch["weight"] = weight
        states, loss_sum, w_sum = step({"m": coll.init("cpu"), "in:m": coll.init("cpu")}, batch)
        return [float(loss_sum), float(w_sum)] + [
            float(v) for k in ("m", "in:m") for v in coll.compute(states[k]).values()]

    padded = run(4, torch.tensor([1.0, 1.0, 1.0, last_weight]))
    three = run(3)
    assert padded[1] == 3.0 + last_weight
    close = all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(padded, three))
    assert close is (last_weight == 0.0)
