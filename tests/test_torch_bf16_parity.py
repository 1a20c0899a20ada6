"""The port's bf16 forwards against the JAX package's bf16 forwards, on the
CPU, with the trained esr_gen weights (`docs/convergence_esr_gen/
best_params.npz`) and the same numpy input, 1 x 32^2 on [0, 1].

The `model-*` cases run the port's bf16 model forward, the `s2d_route-*`
cases its S2D route (`model(x, s2d=True)`, the route a bf16 `s2d_train`
run takes, dense blocks on K1); both against the same JAX forward.

The two round in different places. JAX rounds to bf16 after every op: the
engine runs the Flax model in bf16 (`model.apply` on bf16 params and input),
rounding after each conv, bias add, LeakyReLU, `* 0.2` and `+ x`. The
port's dense blocks round once per level, as its CUDA kernels (K2, K1) do:
f32 inside a level, one rounding at the store; on the CPU they run the
plain versions, which keep that rounding. So the two need not agree bit for
bit.

Bound: 4 bf16 ulps on the [0, 1] output range, 4 * 2^-8 = 1.5625e-2 (the
port's bf16 class: "within 4 bf16 ulps of JAX bf16"). Each case prints its
max|diff| and the share of output pixels that differ.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from xmm_superres_denoise_torch.utils.weights import params_from_flax
from xmm_superres_denoise_tpu import models as jmodels

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"
BF16_4_ULPS = 4 * 2.0**-8  # on [0, 1]


def _trained(dn: bool):
    """The trained weights as a Flax tree (the DN generator takes the trunk
    and conv_last, whose shapes it shares with SR) and as a torch
    state_dict."""
    with np.load(PARAMS) as npz:
        flat = {k: npz[k] for k in npz.files
                if not dn or k.startswith(("params/trunk/", "params/conv_last/"))}
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree, params_from_flax(flat)


def _model_forwards(dn: bool, s2d: bool):
    """JAX: the Flax model applied in bf16, as the JAX engine runs it (params
    and input cast to bf16). Port: the model cast to bf16, on its model or
    its S2D route."""
    tree, state = _trained(dn)
    jmodel = jmodels.GeneratorRRDB_DN() if dn else jmodels.GeneratorRRDB_SR()
    jtree = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)
    model = GeneratorRRDB_DN() if dn else GeneratorRRDB_SR()
    model.load_state_dict(state)
    model.to(torch.bfloat16)
    return (lambda x: jmodel.apply(jtree, jnp.asarray(x, jnp.bfloat16)),
            lambda x: model(torch.from_numpy(x).bfloat16(), s2d=s2d))


@pytest.mark.parametrize("case", ["model-sr", "model-dn", "s2d_route-sr", "s2d_route-dn"])
def test_port_bf16_within_4_ulps_of_jax_bf16(case):
    kind, task = case.split("-")
    x = np.random.default_rng(11).uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    jax_fwd, port_fwd = _model_forwards(task == "dn", s2d=kind == "s2d_route")
    want = np.asarray(jnp.asarray(jax_fwd(x), jnp.float32))
    with torch.inference_mode():
        out = port_fwd(x)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert got.shape == want.shape == ((1, 64, 64, 1) if task == "sr" else x.shape)
    err = np.abs(got - want).max()
    print(f"{case} bf16: max|port - jax| {err:.3e} (bound {BF16_4_ULPS:.4e}), "
          f"{np.mean(got != want):.1%} of pixels differ")
    assert np.isfinite(got).all()
    assert err <= BF16_4_ULPS
