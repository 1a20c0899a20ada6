"""The port's extended metric suite against the JAX package's, on the CPU.

Each of the six per-image functions (GMSD, MS-GMSD, HaarPSI, MDSI, VIF-p,
FSIM) on the same seeded numpy pair at (2, 64, 64, 1) must be within 1e-5
absolute of JAX's; the port's FSIM must also be within 1e-5 of the numpy
oracle (`metrics/fsim_oracle.py`, the port's copy), the bound the JAX
package's own FSIM test holds JAX to. Identity inputs give each metric's
identity value. Each test prints the max|diff| it measured.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.metrics import extended as te
from xmm_superres_denoise_torch.metrics.fsim_oracle import fsim_oracle

je = importlib.import_module("xmm_superres_denoise_tpu.metrics.extended")

SHAPE = (2, 64, 64, 1)
ATOL = 1e-5
NAMES = ["gmsd", "ms_gmsd", "haarpsi", "mdsi", "vif_p", "fsim"]
# the score of an image against itself
IDENTITY = {"gmsd": 0.0, "ms_gmsd": 0.0, "haarpsi": 1.0, "mdsi": 0.0, "vif_p": 1.0, "fsim": 1.0}


def _pair(shape=SHAPE, seed=0, noise=0.05):
    """A structured [0, 1] target (gradients matter here) and a noisy copy."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[1], 0 : shape[2]]
    base = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    t = np.stack([base + 0.05 * g.random(shape[1:3]) for _ in range(shape[0])])
    t = np.clip(t, 0, 1).astype(np.float32)[..., None]
    p = np.clip(t + g.normal(0, noise, t.shape), 0, 1).astype(np.float32)
    return p, t


def _fns(name):
    attr = f"{name}_per_image"
    return getattr(te, attr), getattr(je, attr)


@pytest.mark.parametrize("name", NAMES)
def test_extended_metric_matches_jax(name):
    p, t = _pair(seed=NAMES.index(name))
    tf, jf = _fns(name)
    ours = tf(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    ref = np.asarray(jf(jnp.asarray(p), jnp.asarray(t)))
    diff = float(np.abs(ours - ref).max())
    print(f"{name}: port {ours}, JAX {ref}, max|diff| {diff:.3e} (tol {ATOL:.0e})")
    assert ours.shape == (SHAPE[0],) and np.isfinite(ours).all()
    assert diff <= ATOL


def test_fsim_matches_numpy_oracle():
    g = np.random.default_rng(0)
    a = g.uniform(0, 1, SHAPE).astype(np.float32)
    b = np.clip(a + g.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    ours = te.fsim_per_image(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    oracle = fsim_oracle(a, b)
    diff = float(np.abs(ours - oracle).max())
    print(f"fsim vs oracle: max|diff| {diff:.3e} (tol {ATOL:.0e})")
    assert diff <= ATOL


@pytest.mark.parametrize("name", NAMES)
def test_identity_inputs_give_the_identity_value(name):
    _, t = _pair(seed=7)
    tf, _ = _fns(name)
    x = torch.from_numpy(t)
    score = tf(x, x).numpy()
    diff = float(np.abs(score - IDENTITY[name]).max())
    print(f"{name}(x, x) = {score}, max|diff| from {IDENTITY[name]} {diff:.3e}")
    assert diff <= 1e-4


def test_extended_metrics_register_with_the_bank_and_run_in_float64():
    from xmm_superres_denoise_torch.metrics.collection import MetricBank

    bank = MetricBank(te.EXT_METRIC_NAMES)
    p, t = _pair()
    p64, t64 = torch.from_numpy(p).double(), torch.from_numpy(t).double()
    state = bank.update(bank.init("cpu", torch.float64), p64, t64)
    out = bank.compute(state)
    ref32 = bank.compute(bank.update(bank.init("cpu"), torch.from_numpy(p), torch.from_numpy(t)))
    for n in te.EXT_METRIC_NAMES:
        assert out[n].dtype == torch.float64
        rel = abs(float(out[n]) - float(ref32[n])) / max(abs(float(out[n])), 1e-12)
        print(f"{n}: float64 {float(out[n]):.8f}, float32 {float(ref32[n]):.8f}, rel {rel:.2e}")
        assert rel <= 1e-4
