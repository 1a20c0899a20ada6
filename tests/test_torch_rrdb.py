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

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.config.schema import ConfigError, ModelCfg
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.models import rrdb as port_rrdb
from xmm_superres_denoise_torch.models.rrdb import (
    GeneratorRRDB_DN,
    GeneratorRRDB_SR,
    pixel_shuffle,
)
from xmm_superres_denoise_torch.ops.dense_block import dense_block
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
    """The config takes each zoo model's own section; a section of no model
    is refused (a ConfigError, as JAX's pydantic discriminator refuses it)."""
    section = {"base_model": name}
    if name != "restormer":
        section.update(num_heads=[2], depths=[1])
    assert ModelCfg(name=name, model=section).model.base_model == name
    with pytest.raises(ConfigError, match="base_model"):
        ModelCfg(name=name, model={"base_model": "vit"})


# --------------------------------------------------------------------------
# The dense block's pack of its weights for the kernel, kept between calls
# --------------------------------------------------------------------------


@pytest.fixture
def pack_count(monkeypatch):
    """Counts the model's calls of `pack_weights`."""
    calls = []

    def counting(*args, **kw):
        calls.append(args)
        return pack(*args, **kw)

    pack = port_rrdb.pack_weights
    monkeypatch.setattr(port_rrdb, "pack_weights", counting)
    return calls


def _small_model(seed=0):
    model = GeneratorRRDB_SR(num_filters=8, num_res_blocks=2)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _blocks(model):
    return [m for m in model.modules() if isinstance(m, port_rrdb.ResidualDenseBlock5C)]


def test_forward_packs_each_dense_block_once(pack_count):
    model = _small_model()
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 12, 12, 1)).astype(np.float32))
    with torch.inference_mode():
        first = model(x)
        packs = [b.packed() for b in _blocks(model)]
        second = model(x)
    assert len(pack_count) == 6  # 2 RRDB x 3 blocks, on the first forward only
    assert all(b.packed() is p for b, p in zip(_blocks(model), packs))
    assert torch.equal(first, second)


def test_load_state_dict_and_in_place_changes_repack(pack_count):
    model = _small_model()
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 12, 12, 1)).astype(np.float32))
    with torch.inference_mode():
        model(x)
    other = _small_model(seed=1)
    model.load_state_dict(other.state_dict())
    with torch.inference_mode():
        assert torch.equal(model(x), other(x))
    assert len(pack_count) == 6 + 6 + 6  # model, model again after loading, other
    block = _blocks(model)[0]
    with torch.no_grad():
        block.conv3.weight.mul_(0.5)
    t = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 6, 7, 8)).astype(np.float32))
    with torch.inference_mode():
        got = block(t)
    assert len(pack_count) == 19  # only the changed block
    assert torch.equal(got, dense_block(t, *block.flat_params()))
    model.to(torch.bfloat16)
    with torch.inference_mode():
        assert block(t.bfloat16()).dtype == torch.bfloat16
    assert len(pack_count) == 20 and block.packed().kernel[0].dtype == torch.bfloat16


def test_raw_weight_tuple_still_runs_the_block(pack_count):
    block = _blocks(_small_model())[0]
    t = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 5, 9, 8)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(dense_block(t, *block.flat_params()), block(t))
        assert torch.equal(dense_block(t, block.packed()), block(t))


def test_parameters_made_in_inference_mode_are_packed_on_every_call(pack_count):
    # such parameters keep no version counter, so the cache cannot see an
    # in-place change; the block packs every time instead of going stale
    t = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 6, 6, 8)).astype(np.float32))
    with torch.inference_mode():
        block = port_rrdb.ResidualDenseBlock5C(8, 8)
        a = block(t)
        block.conv1.weight.mul_(0.0)
        b = block(t)
        want = dense_block(t, *block.flat_params())
    assert len(pack_count) == 2
    assert torch.equal(b, want) and not torch.equal(a, b)
