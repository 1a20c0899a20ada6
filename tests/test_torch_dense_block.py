"""The port's dense block (`xmm_superres_denoise_torch/ops/dense_block.py`)
against the JAX package's Pallas kernel and Flax block, on the CPU.

On the CPU `dense_block` runs its plain version; the CUDA kernel itself is
held against that plain version on the card (tests/test_torch_gpu.py and
chip_smoke.py). Tolerance rtol = atol = 2e-5, as tests/test_pallas_rrdb.py
holds the Pallas kernel against Flax: f32 sums of up to 1440 products taken
in another order. In bf16 both round each level's output once: 4 bf16 ulps
x max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.ops.dense_block import (
    _check_args,
    check_packed,
    dense_block,
    dense_block_reference,
    pack_weights,
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


@pytest.mark.parametrize("c", [8, 32])
def test_bf16_plain_version_within_ulps_of_pallas_kernel_interpret(c):
    # both keep f32 inside a level and round each level's output to bf16
    # once, summing in another order: a few bf16 ulps (2^-8 relative) apart
    x = np.random.default_rng(8).normal(size=(1, 13, 21, c)).astype(np.float32)
    ws = [w.astype(jnp.bfloat16) for w in _weights(c, seed=4)]
    want = np.asarray(dense_block_pallas(
        jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(w) for w in ws], tile=(8, 8), interpret=True
    ).astype(jnp.float32))
    got = dense_block(torch.from_numpy(x).bfloat16(),
                      *[torch.from_numpy(np.asarray(w, np.float32)).bfloat16() for w in ws])
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    tol = 4 * 2.0**-8 * np.abs(want).max()
    print(f"C={c} bf16: max|port - pallas interpret| {err:.3e} (tol {tol:.3e})")
    assert err <= tol


def test_packed_block_gives_the_same_block_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 8, 12, 32)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _weights(32, seed=5)]
    for dtype in (torch.float32, torch.bfloat16):
        packed = pack_weights(ws[0::2], ws[1::2], dtype)
        if dtype == torch.bfloat16:  # (9, C, kC)[tap, o, i] == HWIO[tap // 3, tap % 3, i, o]
            assert tuple(packed.kernel[1].shape) == (9, 32, 64)
            assert torch.equal(packed.kernel[1][5], packed.hwio[1][1, 2].t())
        else:
            assert all(k is h for k, h in zip(packed.kernel, packed.hwio))
        before = dense_block.launches
        a = dense_block(x.to(dtype), packed)
        b = dense_block(x.to(dtype), *[w.to(dtype) for w in ws])
        assert dense_block.launches == before
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="ten weight tensors or one PackedBlock"):
        dense_block(x, *ws[:4])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_packed_checks_refuse_misaligned_weights(dtype):
    # both levels copy weights in 16-byte pieces (f32: TMA boxes of HWIO;
    # bf16: TMA or cp.async): a contiguous weight view off a 16-byte boundary
    # is refused, not copied. An f32 pack keeps the caller's tensors, so this
    # also guards ten raw f32 tensors.
    ws = [torch.from_numpy(w) for w in _weights(32)]
    packed = pack_weights(ws[0::2], ws[1::2], dtype)
    x = torch.zeros(1, 4, 4, 32, dtype=dtype)
    check_packed(x, packed)
    w2 = packed.kernel[1]
    shifted = torch.zeros(w2.numel() + 1, dtype=dtype)[1:].view(w2.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == shifted.element_size()
    with pytest.raises(ValueError, match="level 2.*16-byte"):
        check_packed(x, packed._replace(kernel=(packed.kernel[0], shifted) + packed.kernel[2:]))


def test_grid_limit_binds_bf16_only():
    # the bf16 level at C % 128 == 0 launches B * C / 128 blocks along grid
    # z (at most 65535); the bf16 level at C = 32 and the f32 level launch a
    # persistent one-dimensional grid and take any batch
    for c in (32, 128):
        ws = [torch.from_numpy(w) for w in _weights(c)]
        x = torch.zeros(65600, 1, 1, c)
        check_packed(x, pack_weights(ws[0::2], ws[1::2], torch.float32))
        bf16 = pack_weights(ws[0::2], ws[1::2], torch.bfloat16)
        if c == 32:
            check_packed(x.bfloat16(), bf16)
        else:
            with pytest.raises(ValueError, match="cannot take shape"):
                check_packed(x.bfloat16(), bf16)


def test_other_devices_raise_instead_of_falling_back():
    ws = [torch.from_numpy(w).to("meta") for w in _weights(32)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_block(torch.zeros(1, 4, 4, 32, device="meta"), *ws)

