"""The port's space-to-depth dense block K1 (`xmm_superres_denoise_torch/ops/
dense_block_s2d.py`) against the JAX package's Pallas kernel, on the CPU.

On the CPU `dense_block_s2d` runs its plain version; the CUDA kernel is held
against that plain version on the card (tests/test_torch_gpu.py and
chip_smoke.py). f32 tolerance rtol = atol = 2e-5, as
tests/test_pallas_dense_block.py holds the Pallas kernel against the XLA
gather form. bf16: both store each level in bf16 and accumulate in f32, in
another order, so they may differ by a few bf16 ulps: 4 * 2^-8 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.ops.dense_block_s2d import (
    _check_args,
    dense_block_s2d,
    dense_block_s2d_reference,
    pack_weights,
)
from xmm_superres_denoise_tpu.ops.pallas_dense_block import dense_block_s2d_pallas

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ULPS = 4 * 2.0**-8


def _inputs(shape, seed=0):
    g = np.random.default_rng(seed)
    c = shape[-1]
    x = (g.normal(size=shape) * 0.3).astype(np.float32)
    ws = [(g.normal(size=(3, 3, k * c, c)) * 0.1).astype(np.float32) for k in range(1, 6)]
    bs = [(g.normal(size=(c,)) * 0.05).astype(np.float32) for _ in range(5)]
    return x, ws, bs


def _port(x, ws, bs, dtype=torch.float32, **kw):
    return dense_block_s2d(
        torch.from_numpy(x).to(dtype), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], **kw,
    )


@pytest.mark.parametrize("shape,h_strip,w_tile", [
    ((1, 16, 16, 8), 8, 8),
    ((2, 24, 16, 8), 8, 16),
])
def test_plain_version_matches_pallas_interpret(shape, h_strip, w_tile):
    x, ws, bs = _inputs(shape)
    want = np.asarray(dense_block_s2d_pallas(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        h_strip=h_strip, w_tile=w_tile, interpret=True,
    ))
    got = _port(x, ws, bs, h_strip=h_strip, w_tile=w_tile).numpy()
    print(f"{shape}: max|port - pallas interpret| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_plain_version_within_ulps_of_pallas_interpret():
    x, ws, bs = _inputs((1, 16, 16, 8), seed=1)
    want = np.asarray(dense_block_s2d_pallas(
        jnp.asarray(x, jnp.bfloat16), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        h_strip=8, w_tile=8, interpret=True,
    ).astype(jnp.float32))
    got = _port(x, ws, bs, torch.bfloat16, h_strip=8, w_tile=8)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    tol = BF16_ULPS * np.abs(want).max()
    print(f"bf16: max|port - pallas interpret| {err:.3e} (tol {tol:.3e})")
    assert err <= tol


def test_packed_weights_give_the_same_block():
    x, ws, bs = _inputs((1, 8, 16, 8), seed=2)
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    before = dense_block_s2d.launches
    packed = pack_weights(tw, tb, torch.bfloat16)
    assert tuple(packed.kernel[2].shape) == (9, 8, 24)
    np.testing.assert_array_equal(  # (9, C, kC)[tap, o, i] == HWIO[tap // 3, tap % 3, i, o]
        packed.kernel[2][4].float().numpy(), packed.hwio[2][1, 1].float().numpy().T
    )
    xb = torch.from_numpy(x).bfloat16()
    a = dense_block_s2d(xb, packed, h_strip=8, w_tile=16)
    b = dense_block_s2d(xb, tw, tb, h_strip=8, w_tile=16)
    assert torch.equal(a, b) and torch.equal(a, dense_block_s2d_reference(xb, tw, tb))
    assert dense_block_s2d.launches == before  # the CPU never launches


@pytest.mark.parametrize("shape,h_strip,w_tile", [
    ((1, 16, 16, 8), 16, 104),
    ((1, 20, 104, 8), 16, 104),
    ((1, 16, 100, 8), 16, 104),
    ((16, 16, 8), 16, 16),
])
def test_shapes_k1_rejects_raise(shape, h_strip, w_tile):
    x = torch.zeros(shape)
    ws = [torch.zeros(3, 3, 8 * k, 8) for k in range(1, 6)]
    with pytest.raises(ValueError):
        dense_block_s2d(x, ws, [torch.zeros(8)] * 5, h_strip=h_strip, w_tile=w_tile)


def _kernel_arg_cases():
    good = torch.zeros(1, 4, 4, 128)
    ws = [torch.zeros(3, 3, 128 * k, 128) for k in range(1, 6)]
    bs = [torch.zeros(128)] * 5
    return {
        "float64": (good.double(), pack_weights(ws, bs, torch.float64), TypeError),
        "c-not-multiple-of-128": (
            torch.zeros(1, 4, 4, 64),
            pack_weights([torch.zeros(3, 3, 64 * k, 64) for k in range(1, 6)],
                         [torch.zeros(64)] * 5, torch.float32), ValueError),
        "non-contiguous": (torch.zeros(1, 4, 4, 256)[..., ::2],
                           pack_weights(ws, bs, torch.float32), ValueError),
        "weight-dtype": (good.bfloat16(), pack_weights(ws, bs, torch.float32), ValueError),
        "weight-shape": (good, pack_weights(ws[:4] + [ws[0]], bs, torch.float32), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_kernel_arg_cases()))
def test_kernel_argument_checks_raise(case):
    x, packed, err = _kernel_arg_cases()[case]
    with pytest.raises(err):
        _check_args(x, packed)


def test_kernel_argument_checks_refuse_misaligned_bf16_weights():
    # the bf16 levels copy weights in 16-byte pieces (TMA at C % 128 == 0):
    # a contiguous weight view 2 bytes past a boundary is refused, not copied
    ws = [torch.zeros(3, 3, 128 * k, 128) for k in range(1, 6)]
    packed = pack_weights(ws, [torch.zeros(128)] * 5, torch.bfloat16)
    w2 = packed.kernel[1]
    shifted = torch.zeros(w2.numel() + 1, dtype=torch.bfloat16)[1:].view(w2.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    x = torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16)
    _check_args(x, packed)
    with pytest.raises(ValueError, match="level 2.*16-byte"):
        _check_args(x, packed._replace(kernel=(packed.kernel[0], shifted) + packed.kernel[2:]))


def test_other_devices_raise_instead_of_falling_back():
    ws = [torch.zeros(3, 3, 8 * k, 8, device="meta") for k in range(1, 6)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_block_s2d(torch.zeros(1, 8, 8, 8, device="meta"), ws,
                        [torch.zeros(8, device="meta")] * 5, h_strip=8, w_tile=8)
