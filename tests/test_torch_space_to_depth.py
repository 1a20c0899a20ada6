"""The port's space-to-depth transform (`xmm_superres_denoise_torch/ops/
space_to_depth.py`) and its bf16 scalar rounding (`ops/precision.py`)
against the JAX package, on the CPU.

s2d/d2s are permutations and the weight transform a scatter: both must be
bitwise equal to JAX's. The conv identity holds to f32 rounding (1e-5 on
O(1) activations: sums of 288 products in another order). The bf16 scalar
products and LeakyReLU must equal `jnp`'s bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
import torch.nn.functional as F

from xmm_superres_denoise_torch.models.rrdb import pixel_shuffle, pixel_unshuffle
from xmm_superres_denoise_torch.ops import space_to_depth as tsd
from xmm_superres_denoise_torch.ops.precision import lrelu, scalar_like
from xmm_superres_denoise_tpu.models import rrdb as jrrdb
from xmm_superres_denoise_tpu.ops import space_to_depth as jsd


@pytest.mark.parametrize("shape", [(2, 8, 12, 3), (1, 6, 4, 32)])
def test_s2d_d2s_and_pixel_unshuffle_equal_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = tsd.s2d(torch.from_numpy(x)).numpy()
    want = np.array(jsd.s2d(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pixel_unshuffle(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jrrdb.pixel_unshuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tsd.d2s(torch.from_numpy(got)).numpy(), x)
    np.testing.assert_array_equal(
        tsd.d2s(torch.from_numpy(want)).numpy(), np.asarray(jsd.d2s(jnp.asarray(want)))
    )
    # channels-first torch pixel_unshuffle has the same channel order
    nchw = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)
    assert torch.equal(pixel_shuffle(pixel_unshuffle(torch.from_numpy(x), 2), 2),
                       torch.from_numpy(x))


@pytest.mark.parametrize("cin,cout", [(1, 32), (32, 32), (5, 3)])
def test_s2d_conv_weights_bitwise_equal_jax(cin, cout):
    g = np.random.default_rng(cin * 100 + cout)
    w = g.normal(size=(3, 3, cin, cout)).astype(np.float32)
    b = g.normal(size=(cout,)).astype(np.float32)
    w2, b2 = tsd.s2d_conv_weights(w, b)
    jw2, jb2 = jsd.s2d_conv_weights(w, b)
    assert w2.dtype == jw2.dtype and b2.dtype == jb2.dtype
    np.testing.assert_array_equal(w2, jw2)
    np.testing.assert_array_equal(b2, jb2)
    np.testing.assert_array_equal(tsd.S2D_M, jsd._S2D_M)


def test_torch_differentiable_form_equals_numpy_form_and_has_exact_grads():
    g = np.random.default_rng(1)
    w = torch.from_numpy(g.normal(size=(3, 3, 4, 6)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(g.normal(size=(6,)).astype(np.float32))
    w2, b2 = tsd.s2d_conv_weights_torch(w, b)
    nw2, nb2 = tsd.s2d_conv_weights(w.detach().numpy(), b.numpy())
    np.testing.assert_array_equal(w2.detach().numpy(), nw2)
    np.testing.assert_array_equal(b2.numpy(), nb2)
    # the transform is linear with 0/1 coefficients: d(sum T(w) * G)/dw
    # equals the JAX form's gradient
    cot = g.normal(size=w2.shape).astype(np.float32)
    (w2 * torch.from_numpy(cot)).sum().backward()
    import jax

    jgrad = jax.grad(lambda v: jnp.sum(jsd.s2d_conv_weights_jnp(v)[0] * cot))(
        jnp.asarray(w.detach().numpy())
    )
    print(f"max|grad port - jax| {np.abs(w.grad.numpy() - np.asarray(jgrad)).max():.3e}")
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)


def test_conv_identity_through_s2d():
    g = np.random.default_rng(2)
    x = torch.from_numpy(g.normal(size=(2, 12, 16, 8)).astype(np.float32))
    w = g.normal(size=(3, 3, 8, 4)).astype(np.float32) * 0.2
    b = g.normal(size=(4,)).astype(np.float32)
    direct = F.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
                      torch.from_numpy(b), padding=1).permute(0, 2, 3, 1)
    w2, b2 = tsd.s2d_conv_weights(w, b)
    via = F.conv2d(tsd.s2d(x).permute(0, 3, 1, 2), torch.from_numpy(w2).permute(3, 2, 0, 1),
                   torch.from_numpy(b2), padding=1).permute(0, 2, 3, 1)
    err = (tsd.d2s(via) - direct).abs().max().item()
    print(f"max|d2s(conv(s2d(x), T(w))) - conv(x, w)| {err:.3e}")
    assert err <= 1e-5


@pytest.mark.parametrize("s", [0.2, 0.01, 127.0 / 3.7])
def test_bf16_scalar_products_and_lrelu_equal_jnp(s):
    g = np.random.default_rng(3)
    x = (g.normal(size=100_000) * 3).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    want_mul = np.asarray((jx * s).astype(jnp.float32))
    want_lrelu = np.asarray(jnp.where(jx >= 0, jx, s * jx).astype(jnp.float32))
    got_mul = (tx * scalar_like(tx, s)).float().numpy()
    got_lrelu = lrelu(tx, s).float().numpy()
    unrounded = (tx * s).float().numpy()  # torch's own scalar product, for the record
    print(f"slope {s}: bf16 products differing from jnp: helper "
          f"{(got_mul != want_mul).mean():.4%}, plain torch scalar {(unrounded != want_mul).mean():.4%}")
    np.testing.assert_array_equal(got_mul, want_mul)
    np.testing.assert_array_equal(got_lrelu, want_lrelu)
    # f32 is unchanged: the scalar rounds to itself
    x32 = torch.from_numpy(x)
    assert torch.equal(x32 * scalar_like(x32, s), x32 * s)
