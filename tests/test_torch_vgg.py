"""The port's VGG perceptual loss (`metrics/vgg.py`) against the JAX
package's, on the CPU.

* `VGGFeatures` and `VGGLoss` with the same random weights: JAX's Flax init
  carried across by `utils/weights.py: vgg_state_from_flax`, vgg11 and
  vgg19 cut at `layers = 8`, on 32^2 inputs; within 1e-5 relative (f32, the
  convolutions summed in another order);
* `load_vgg_params_npz` from the npz `scripts/export_vgg_npz.py` writes of
  a torchvision-layout state dict: the port's module then holds those
  weights, and JAX's loader of the same npz gives the same features.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.metrics import vgg as tvgg
from xmm_superres_denoise_torch.utils.weights import vgg_state_from_flax

jvgg = importlib.import_module("xmm_superres_denoise_tpu.metrics.vgg")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from export_vgg_npz import state_dict_to_npz_arrays  # noqa: E402

RTOL = 1e-5


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _pair(seed=0, shape=(2, 32, 32, 1)):
    g = np.random.default_rng(seed)
    preds = g.uniform(0, 1, shape).astype(np.float32)
    target = np.clip(preds + 0.05 * g.normal(size=shape), 0, 1).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("model", ["vgg11", "vgg19"])
def test_features_and_loss_match_jax_with_the_same_weights(model):
    jloss = jvgg.VGGLoss(model, layers=8, seed=3)
    state = vgg_state_from_flax(jloss.params, model, layers=8)
    loss = tvgg.VGGLoss(model, layers=8, params=state)
    assert sorted(loss.net.state_dict()) == sorted(state)
    preds, target = _pair()
    x = np.repeat(preds, 3, axis=-1)
    want_f = np.asarray(jloss.net.apply(jloss.params, jnp.asarray(x)))
    got_f = loss.net(torch.from_numpy(x)).detach().numpy()
    want = float(jloss(jnp.asarray(preds), jnp.asarray(target)))
    with torch.no_grad():
        got = float(loss(torch.from_numpy(preds), torch.from_numpy(target)))
    rel_f, rel = _rel(got_f, want_f), abs(got - want) / abs(want)
    print(f"{model}[:9] features {got_f.shape}: max|port - JAX| / max|JAX| {rel_f:.3e}; loss port "
          f"{got:.8e} JAX {want:.8e} (rel {rel:.3e}, tol {RTOL})")
    want_shape = {"vgg11": (2, 8, 8, 256), "vgg19": (2, 16, 16, 128)}[model]  # features[:9]
    assert got_f.shape == want_f.shape == want_shape
    assert rel_f <= RTOL and rel <= RTOL


def test_seeded_loss_is_deterministic_and_zero_on_equal_inputs():
    preds, target = _pair(seed=1)
    a = tvgg.VGGLoss("vgg11", layers=4, seed=7)
    b = tvgg.VGGLoss("vgg11", layers=4, seed=7)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    with torch.no_grad():
        assert float(a(p, t)) == float(b(p, t)) > 0.0
        assert float(a(p, p)) == 0.0
    assert list(a.net.state_dict()) == ["features.0.weight", "features.0.bias",
                                        "features.3.weight", "features.3.bias"]


def test_load_vgg_params_npz_from_the_export_script(tmp_path):
    cfg = tvgg.VGG_CONFIGS["vgg11"]
    full = tvgg.VGGFeatures("vgg11", layers=len(tvgg._torchvision_modules(cfg)) - 1)
    full.reset_parameters(torch.Generator().manual_seed(5))
    sd = {**full.state_dict(), "classifier.0.weight": torch.zeros(4, 4)}  # a whole VGG's keys
    path = tmp_path / "vgg11_features.npz"
    np.savez(path, **state_dict_to_npz_arrays(sd))
    net = tvgg.load_vgg_params_npz(path, "vgg11", layers=8)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, full.state_dict()[k], rtol=0, atol=0)
    x = np.random.default_rng(2).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    got = net(torch.from_numpy(x)).detach().numpy()
    jparams = jvgg.load_vgg_params_npz(path, "vgg11", layers=8)
    want = np.asarray(jvgg.VGGFeatures("vgg11", 8).apply(jparams, jnp.asarray(x)))
    print(f"vgg11 from the exported npz: max|port - JAX| / max|JAX| {_rel(got, want):.3e} "
          f"(tol {RTOL})")
    assert _rel(got, want) <= RTOL
