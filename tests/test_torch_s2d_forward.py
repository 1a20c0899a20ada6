"""The port's space-to-depth forwards (`xmm_superres_denoise_torch/ops/
s2d_forward.py`) and the fast RRDB forward (`ops/dense_block.py:
make_fast_rrdb_forward`) against the JAX package's, on the CPU, in f32.

Same numpy-seeded inputs and the same Flax weights through both: the
trained esr_gen checkpoint for SR, seeded torch-default inits (as a Flax
tree) for DN and the narrow fast forward. Tolerance 1e-5 on the [0, 1] output scale (f32 sums of up to
5,760 products taken in another order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops.dense_block import make_fast_rrdb_forward
from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_dn_forward, make_s2d_sr_forward
from xmm_superres_denoise_torch.utils.weights import flax_tree, params_from_flax
from xmm_superres_denoise_tpu import models as jmodels
from xmm_superres_denoise_tpu.ops import pallas_rrdb as jrrdb
from xmm_superres_denoise_tpu.ops import s2d_forward as jsf

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"
ATOL = 1e-5


def _trained_tree():
    tree: dict = {}
    with np.load(PARAMS) as npz:
        for key in npz.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(npz[key])
    return tree


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _compare(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    print(f"{what}: max|port - jax| {err:.3e}")
    assert err <= ATOL, err


def test_s2d_sr_forward_matches_jax_with_trained_weights():
    x = _x((2, 32, 32, 1), 1)
    tree = _trained_tree()
    want = jsf.make_s2d_sr_forward(jmodels.GeneratorRRDB_SR(num_upsample=1), tree,
                                   dtype=jnp.float32)(jnp.asarray(x))
    fwd = make_s2d_sr_forward(GeneratorRRDB_SR(), PARAMS, dtype=torch.float32, device="cpu")
    _compare(fwd(torch.from_numpy(x)), want, "S2D SR forward, trained, 2x32^2")


def _seeded(model, seed):
    """The model with torch-default inits drawn from `seed`, and the same
    weights as a Flax tree for the JAX package."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model, {"params": flax_tree(model.state_dict())}


def test_s2d_dn_forward_matches_jax_with_seeded_weights():
    x = _x((2, 32, 32, 1), 2)
    model, params = _seeded(GeneratorRRDB_DN(num_filters=32, num_res_blocks=2), 0)
    jmodel = jmodels.GeneratorRRDB_DN(num_filters=32, num_res_blocks=2)
    want = jsf.make_s2d_dn_forward(jmodel, params, dtype=jnp.float32)(jnp.asarray(x))
    fwd = make_s2d_dn_forward(model, params, dtype=torch.float32, device="cpu")
    _compare(fwd(torch.from_numpy(x)), want, "S2D DN forward, seeded, 2x32^2")


def test_fast_rrdb_forward_matches_jax_interpret():
    x = _x((1, 16, 16, 1), 3)
    model, params = _seeded(GeneratorRRDB_SR(num_filters=8, num_res_blocks=1), 1)
    jmodel = jmodels.GeneratorRRDB_SR(num_filters=8, num_res_blocks=1, num_upsample=1)
    want = jrrdb.make_fast_rrdb_forward(jmodel, params, dtype=jnp.float32, tile=(16, 16),
                                        interpret=True)(jnp.asarray(x))
    fwd = make_fast_rrdb_forward(model, params, dtype=torch.float32, device="cpu")
    _compare(fwd(torch.from_numpy(x)), want, "fast RRDB forward nf=8 nb=1 vs Pallas interpret")


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "dn"])
def test_full_width_forwards_match_the_model(sr):
    x = torch.from_numpy(_x((2, 32, 32, 1), 4))
    model = GeneratorRRDB_SR() if sr else GeneratorRRDB_DN()
    if sr:
        model.load_state_dict(params_from_flax(PARAMS))
    else:
        model.reset_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    with torch.inference_mode():
        want = torch.clamp(model(x), 0, 1)
        s2d_fwd = (make_s2d_sr_forward if sr else make_s2d_dn_forward)(
            model, state, dtype=torch.float32, device="cpu")
        for name, fwd in (("fast", make_fast_rrdb_forward), ("s2d", None)):
            f = s2d_fwd if fwd is None else fwd(model, state, dtype=torch.float32, device="cpu")
            got = f(x)
            err = (got - want).abs().max().item()
            print(f"{name} {'SR' if sr else 'DN'} forward vs model forward: {err:.3e}")
            assert err <= ATOL


def test_bf16_s2d_forward_tracks_f32():
    x = torch.from_numpy(_x((1, 32, 32, 1), 5))
    model = GeneratorRRDB_SR()
    f32 = make_s2d_sr_forward(model, PARAMS, dtype=torch.float32, device="cpu")(x)
    bf16 = make_s2d_sr_forward(model, PARAMS, dtype=torch.bfloat16, device="cpu")(x)
    assert bf16.dtype == torch.bfloat16
    err = (bf16.float() - f32).abs().max().item()
    print(f"bf16 vs f32 S2D SR forward: {err:.3e}")
    assert err <= 0.05


def test_bf16_fast_forward_tracks_f32():
    # 4 bf16 ulps at the top of the [0, 1] output range, as on the card
    x = torch.from_numpy(_x((1, 32, 32, 1), 6))
    model = GeneratorRRDB_SR()
    f32 = make_fast_rrdb_forward(model, PARAMS, dtype=torch.float32, device="cpu")(x)
    bf16 = make_fast_rrdb_forward(model, PARAMS, dtype=torch.bfloat16, device="cpu")(x)
    assert bf16.dtype == torch.bfloat16
    err = (bf16.float() - f32).abs().max().item()
    print(f"bf16 vs f32 fast forward: {err:.3e}")
    assert err <= 4 * 2.0**-8


def test_s2d_forward_refuses_two_upsample_stages():
    with pytest.raises(ValueError, match="num_upsample"):
        make_s2d_sr_forward(GeneratorRRDB_SR(num_filters=8, num_res_blocks=1, num_upsample=2),
                            {}, device="cpu")
