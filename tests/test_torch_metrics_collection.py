"""The port's accumulating metric collections against the JAX package's, on
the CPU.

`MetricBank` and `XMMMetricCollection` (core metrics, and the input-baseline
twin) run 3 updates on the same seeded numpy batches, one row of one update
weighted 0, with a sqrt dataset normalizer and every scaling normalizer
(linear, sqrt, asinh, log). `compute()` must be within 1e-5 relative of
JAX's, and the keys must equal JAX's `{prefix}/{mode}/{in/}{metric}`. The
core suite holds MS-SSIM, which needs 13 * 16 = 208 px per side, so these
batches are (2, 208, 208, 1), the one exception to the fast suite's 64^2
rule (as in `test_torch_loss.py`). Each test prints the max relative
difference it measured.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.metrics import collection as tc
from xmm_superres_denoise_torch.ops.stretch import Normalizer as TNormalizer

jc = importlib.import_module("xmm_superres_denoise_tpu.metrics.collection")
JNormalizer = importlib.import_module("xmm_superres_denoise_tpu.ops.stretch").Normalizer

RTOL = 1e-5
SHAPE = (2, 208, 208, 1)
MODES = ("linear", "sqrt", "asinh", "log")
LR_MAX, HR_MAX = 0.0022336, 0.0005584


def _batches(n=3, seed=0):
    """n (preds, target, weights) batches in [0, 1]; the second update
    weights its last row 0."""
    g = np.random.default_rng(seed)
    out = []
    for k in range(n):
        coarse = g.uniform(0.05, 1, (SHAPE[0], SHAPE[1] // 8, SHAPE[2] // 8, 1))
        t = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
        t = np.clip(t + 0.05 * g.normal(size=SHAPE), 0, 1).astype(np.float32)
        p = np.clip(t + 0.1 * g.normal(size=SHAPE), 1e-3, 1).astype(np.float32)
        w = np.ones(SHAPE[0], np.float32)
        if k == 1:
            w[-1] = 0.0
        out.append((p, t, w))
    return out


def _run(mod, normalizer, to, init, baseline):
    coll = mod.XMMMetricCollection(
        normalizer(LR_MAX, HR_MAX, "sqrt"), [normalizer(LR_MAX, HR_MAX, m) for m in MODES],
        prefix="val", input_baseline=baseline,
    )
    state = init(coll)
    for p, t, w in _batches():
        state = coll.update(state, to(p), to(t), to(w))
    return {k: float(v) for k, v in coll.compute(state).items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("baseline", [False, True], ids=["core", "input-baseline"])
def test_collection_matches_jax_for_every_scaling_normalizer(baseline):
    ours = _run(tc, TNormalizer, torch.from_numpy, lambda c: c.init("cpu"), baseline)
    ref = _run(jc, JNormalizer, jnp.asarray, lambda c: c.init(), baseline)
    assert sorted(ours) == sorted(ref)
    base = "in/" if baseline else ""
    assert sorted(ours) == sorted(f"val/{m}/{base}{n}" for m in MODES for n in tc.CORE_METRIC_NAMES)
    worst = max(_rel(ours[k], ref[k]) for k in ref)
    print(f"{len(ref)} metrics, max relative diff {worst:.3e} (tol {RTOL:.0e}); "
          f"e.g. val/sqrt/{base}psnr {ours[f'val/sqrt/{base}psnr']:.6f}")
    for k in ref:
        assert np.isfinite(ours[k]) and _rel(ours[k], ref[k]) <= RTOL, (k, ours[k], ref[k])


def test_metric_bank_matches_jax_with_weights():
    tb, jb = tc.MetricBank(), jc.MetricBank()
    ts, js = tb.init("cpu"), jb.init()
    for p, t, w in _batches(seed=3):
        ts = tb.update(ts, torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w))
        js = jb.update(js, jnp.asarray(p), jnp.asarray(t), jnp.asarray(w))
    ours = {k: float(v) for k, v in tb.compute(ts).items()}
    ref = {k: float(v) for k, v in jb.compute(js).items()}
    for k in ref:  # the accumulated (sum, count) pairs too
        for a, b in zip(ts[k], js[k]):
            assert _rel(float(a), float(b)) <= RTOL, (k, float(a), float(b))
    worst = max(_rel(ours[k], ref[k]) for k in ref)
    print(f"bank: {ours}; max relative diff {worst:.3e} (tol {RTOL:.0e})")
    assert worst <= RTOL


def test_poisson_accumulates_batch_means_over_the_image_count():
    """The reference's as-is accumulation: one weighted batch mean per
    update, divided by the total weight (image count) at compute time."""
    bank = tc.MetricBank(["poisson"])
    state = bank.init("cpu", torch.float64)
    means, count = [], 0.0
    for p, t, w in _batches(seed=5):
        p64, t64, w64 = (torch.from_numpy(a).double() for a in (p, t, w))
        state = bank.update(state, p64, t64, w64)
        per = (p64 - t64 * torch.log(p64 + 1e-8)).reshape(p.shape[0], -1).mean(-1)
        means.append(float((per * w64).sum() / w64.sum()))
        count += float(w64.sum())
    assert float(bank.compute(state)["poisson"]) == pytest.approx(sum(means) / count, rel=1e-12)


def test_unknown_metric_is_refused():
    with pytest.raises(ValueError, match="Unknown metrics"):
        tc.MetricBank(["psnr", "nope"])
