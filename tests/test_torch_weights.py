"""`params_from_flax`: the Flax RRDB tree -> a PyTorch state_dict."""

from pathlib import Path

import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from xmm_superres_denoise_torch.utils.weights import params_from_flax

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"


@pytest.fixture(scope="module")
def flat():
    with np.load(PARAMS) as npz:
        return {k: npz[k] for k in npz.files}


def test_maps_all_130_trained_arrays(flat):
    assert len(flat) == 130
    state = params_from_flax(PARAMS)
    assert len(state) == 130
    model = GeneratorRRDB_SR()
    model.load_state_dict(state, strict=True)
    assert set(state) == set(model.state_dict())


def test_layouts_hwio_for_the_kernel_and_oihw_for_conv2d(flat):
    state = params_from_flax(flat)
    dense = flat["params/trunk/rrdb_2/RDB3/conv4/kernel"]
    got = state["trunk.rrdb_2.RDB3.conv4.weight"]
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), dense)  # HWIO, unchanged
    first = flat["params/trunk/conv_first/kernel"]  # (3, 3, 1, 32)
    np.testing.assert_array_equal(
        state["trunk.conv_first.weight"].numpy(), first.transpose(3, 2, 0, 1)
    )
    assert state["upconv_0.weight"].shape == (128, 32, 3, 3)


def test_nested_tree_and_path_give_the_same_state(flat):
    nested: dict = {}
    for key, value in flat.items():
        node = nested
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    a, b = params_from_flax(nested), params_from_flax(PARAMS)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_dn_subset_loads_into_the_denoiser(flat):
    dn = {k: v for k, v in flat.items() if not k.startswith(("params/upconv", "params/HRconv"))}
    GeneratorRRDB_DN().load_state_dict(params_from_flax(dn), strict=True)


@pytest.mark.parametrize(
    "key",
    [
        "params/trunk/rrdb_1/RDB2/conv3/kernel",
        "params/trunk/rrdb_0/RDB1/conv1/bias",
        "params/trunk/conv_first/kernel",
        "params/HRconv/bias",
        "params/conv_last/kernel",
    ],
)
def test_missing_key_raises(flat, key):
    broken = {k: v for k, v in flat.items() if k != key}
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(broken)


@pytest.mark.parametrize(
    "key",
    [
        "params/trunk/rrdb_0/RDB4/conv1/kernel",
        "params/trunk/rrdb_0/RDB1/conv6/kernel",
        "params/extra/kernel",
        "params/conv_last/scale",
    ],
)
def test_extra_key_raises(flat, key):
    broken = dict(flat)
    broken[key] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        params_from_flax(broken)


def test_hrconv_without_upconv_is_rejected(flat):
    broken = {k: v for k, v in flat.items() if not k.startswith("params/upconv")}
    with pytest.raises(KeyError, match="unexpected"):
        params_from_flax(broken)
