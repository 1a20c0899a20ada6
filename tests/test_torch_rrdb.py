"""The port's RRDB generators against the JAX package's Flax models, on the
CPU in f32, with the trained esr_gen weights
(`docs/convergence_esr_gen/best_params.npz`).

Tolerance atol 1e-5 on the [0, 1] output scale: the same f32 arithmetic
through 65 convolutions, summed in another order.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.config.schema import ModelCfg
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.models.rrdb import (
    GeneratorRRDB_DN,
    GeneratorRRDB_SR,
    pixel_shuffle,
)
from xmm_superres_denoise_torch.utils.weights import params_from_flax
from xmm_superres_denoise_tpu.models import rrdb as flax_rrdb

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"
ATOL = 1e-5


def _flax_tree(flat):
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


@pytest.fixture(scope="module")
def trained():
    with np.load(PARAMS) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)


def test_sr_trained_weights_match_flax(trained, x64):
    ref = np.asarray(flax_rrdb.GeneratorRRDB_SR().apply(_flax_tree(trained), jnp.asarray(x64)))
    model = GeneratorRRDB_SR()
    model.load_state_dict(params_from_flax(trained))
    with torch.inference_mode():
        out = model(torch.from_numpy(x64)).numpy()
    assert out.shape == (2, 128, 128, 1)
    print(f"max|port SR - flax SR| {np.abs(out - ref).max():.3e}")
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_dn_trained_trunk_matches_flax(trained, x64):
    # the DN generator shares the SR trunk and conv_last shapes
    dn = {k: v for k, v in trained.items()
          if k.startswith(("params/trunk/", "params/conv_last/"))}
    ref = np.asarray(flax_rrdb.GeneratorRRDB_DN().apply(_flax_tree(dn), jnp.asarray(x64)))
    model = GeneratorRRDB_DN()
    model.load_state_dict(params_from_flax(dn))
    with torch.inference_mode():
        out = model(torch.from_numpy(x64)).numpy()
    assert out.shape == x64.shape
    print(f"max|port DN - flax DN| {np.abs(out - ref).max():.3e}")
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax_and_torch_order(r):
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 4 * r * r)).astype(np.float32)
    out = pixel_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(flax_rrdb.pixel_shuffle(jnp.asarray(x), r))
    )
    # NCHW torch.nn.PixelShuffle is the channel order the reference uses
    nchw = torch.nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r)
    assert torch.equal(out, nchw.permute(0, 2, 3, 1))


def test_default_inits_follow_torch_bounds():
    g = torch.Generator().manual_seed(0)
    model = GeneratorRRDB_SR(num_filters=32, num_res_blocks=1)
    model.reset_parameters(g)
    w = model.trunk.rrdb_0.RDB1.conv5.weight
    assert w.shape == (3, 3, 160, 32)  # HWIO, the kernel's layout
    assert w.abs().max() <= 1 / np.sqrt(160 * 9)
    stdv = 1 / np.sqrt(32)  # conv_last: in_channels only, positive offset
    last = model.conv_last.weight
    assert last.min() >= -stdv and last.max() <= 1.01 * stdv
    assert last.max() > 1 / np.sqrt(32 * 9)  # the wide bound, not fan_in's
    again = GeneratorRRDB_SR(num_filters=32, num_res_blocks=1)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


def _cfg(name, **kw):
    return ModelCfg(name=name, model={"base_model": name, **kw})


@pytest.mark.parametrize("lr,hr,stages", [(416, 832, 1), (64, 256, 2)])
def test_registry_builds_sr_stages(lr, hr, stages):
    model = build_model(_cfg("esr_gen", filters=8, residual_blocks=1), (lr, lr), (hr, hr))
    assert isinstance(model, GeneratorRRDB_SR) and model.num_upsample == stages


def test_registry_builds_dn_and_rejects_bad_scale():
    assert isinstance(
        build_model(_cfg("rrdb_denoise", filters=8), (64, 64), (64, 64)), GeneratorRRDB_DN
    )
    with pytest.raises(ValueError, match="power-of-two"):
        build_model(_cfg("esr_gen"), (64, 64), (192, 192))


@pytest.mark.parametrize("name", ["swinir", "swinfir", "drct", "hat", "restormer"])
def test_unported_models_raise_not_implemented(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ModelCfg(name=name, model={"base_model": "esr_gen"})
