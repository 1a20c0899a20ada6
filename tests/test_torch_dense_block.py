"""The port's dense block (`xmm_superres_denoise_torch/ops/dense_block.py`)
against the JAX package's Pallas kernel and Flax block, on the CPU.

On the CPU `dense_block` runs its plain version; the CUDA kernel itself is
held against that plain version on the card (tests/test_torch_gpu.py and
chip_smoke.py). Tolerance rtol = atol = 2e-5, as tests/test_pallas_rrdb.py
holds the Pallas kernel against Flax: f32 sums of up to 1440 products taken
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.ops.dense_block import (
    _check_args,
    dense_block,
    dense_block_reference,
)
from xmm_superres_denoise_tpu.models.rrdb import ResidualDenseBlock5C
from xmm_superres_denoise_tpu.ops.pallas_rrdb import dense_block_pallas

TOL = dict(rtol=2e-5, atol=2e-5)


def _weights(c, seed=0):
    g = np.random.default_rng(seed)
    ws = []
    for j in range(1, 6):
        ws.append((g.normal(size=(3, 3, c * j, c)) * 0.05).astype(np.float32))
        ws.append((g.normal(size=(c,)) * 0.05).astype(np.float32))
    return ws


def _torch_block(x, ws, dtype=torch.float32):
    return dense_block(
        torch.from_numpy(x).to(dtype), *[torch.from_numpy(w).to(dtype) for w in ws]
    )


def test_matches_pallas_kernel_interpret():
    x = np.random.default_rng(3).normal(size=(1, 13, 21, 8)).astype(np.float32)
    ws = _weights(8)
    ref = dense_block_pallas(
        jnp.asarray(x), *[jnp.asarray(w) for w in ws], tile=(8, 8), interpret=True
    )
    out = _torch_block(x, ws).numpy()
    print(f"max|port - pallas interpret| {np.abs(out - np.asarray(ref)).max():.3e}")
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_matches_flax_block_at_c32():
    x = np.random.default_rng(4).normal(size=(2, 24, 24, 32)).astype(np.float32)
    ws = _weights(32, seed=1)
    params = {
        "params": {
            f"conv{j}": {"kernel": jnp.asarray(ws[2 * j - 2]), "bias": jnp.asarray(ws[2 * j - 1])}
            for j in range(1, 6)
        }
    }
    ref = np.asarray(ResidualDenseBlock5C(32, 32).apply(params, jnp.asarray(x)))
    out = _torch_block(x, ws).numpy()
    print(f"max|port - flax block| {np.abs(out - ref).max():.3e}")
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_input_runs_plain_version_without_launch():
    x = np.random.default_rng(5).normal(size=(1, 10, 12, 32)).astype(np.float32)
    ws = _weights(32, seed=2)
    before = dense_block.launches
    out = _torch_block(x, ws)
    ref = dense_block_reference(
        torch.from_numpy(x), *[torch.from_numpy(w) for w in ws]
    )
    assert dense_block.launches == before
    assert torch.equal(out, ref)


def test_bf16_plain_version_tracks_f32():
    # bf16 stores each level's activations in bf16 (as the kernel does) and
    # accumulates in f32: the result stays within a few bf16 ulps (2^-8
    # relative) of the f32 block
    x = np.random.default_rng(6).normal(size=(1, 12, 12, 32)).astype(np.float32)
    ws = _weights(32, seed=3)
    f32 = _torch_block(x, ws).numpy()
    bf16 = _torch_block(x, ws, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    err = np.abs(bf16.float().numpy() - f32).max()
    assert err <= 4 * 2.0**-8 * np.abs(f32).max(), err


def _bad_inputs():
    good_x = torch.zeros(1, 8, 8, 32)
    good_w = [torch.from_numpy(w) for w in _weights(32)]
    bad_w = list(good_w)
    bad_w[4] = torch.zeros(3, 3, 32, 32)  # level 3 needs 96 input channels
    mixed = list(good_w)
    mixed[9] = mixed[9].double()
    return {
        "not-nhwc": (torch.zeros(8, 8, 32), good_w, ValueError),
        "float64": (good_x.double(), [w.double() for w in good_w], TypeError),
        "c-not-multiple-of-32": (
            torch.zeros(1, 8, 8, 8), [torch.from_numpy(w) for w in _weights(8)], ValueError
        ),
        "non-contiguous": (torch.zeros(1, 8, 8, 64)[..., ::2], good_w, ValueError),
        "weight-shape": (good_x, bad_w, ValueError),
        "weight-dtype": (good_x, mixed, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_kernel_argument_checks_raise(case):
    x, ws, err = _bad_inputs()[case]
    with pytest.raises(err):
        _check_args(x, ws)


def test_good_kernel_arguments_pass_checks():
    _check_args(torch.zeros(2, 9, 7, 32), [torch.from_numpy(w) for w in _weights(32)])


def test_other_devices_raise_instead_of_falling_back():
    ws = [torch.from_numpy(w).to("meta") for w in _weights(32)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_block(torch.zeros(1, 4, 4, 32, device="meta"), *ws)
