"""Card-only tests of the port: the CUDA kernels (K2, K1, P, K3) against
their plain versions, and the model and the S2D, fast and int8 forwards
through them.

Every test here is marked `gpu` and skips without a CUDA card; whether a card
is present is decided inside the `cuda` fixture, never at import. This file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Tolerances: f32 with TF32 off differs from cuDNN only in summation order
(atol 1e-4 on O(1) activations); bf16 stores each level in bf16 in both
versions, so they may differ by a few bf16 ulps (2^-8 relative). The int8
kernels are exact: their int32 sums must equal the plain versions'.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops.conv_i8 import conv_i8, conv_i8_reference
from xmm_superres_denoise_torch.ops.dense_block import dense_block, dense_block_reference
from xmm_superres_denoise_torch.ops.dense_block_s2d import (
    dense_block_s2d,
    dense_block_s2d_reference,
    pack_weights,
)
from xmm_superres_denoise_torch.ops.int8_gemm import PROBE_SHAPE, int8_gemm, int8_gemm_reference
from xmm_superres_denoise_torch.ops.precision import true_f32
from xmm_superres_denoise_torch.utils.weights import params_from_flax

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _block_inputs(shape, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(g.normal(size=shape).astype(np.float32))
    ws = []
    for j in range(1, 6):
        ws.append(torch.from_numpy((g.normal(size=(3, 3, c * j, c)) * 0.05).astype(np.float32)))
        ws.append(torch.from_numpy((g.normal(size=(c,)) * 0.05).astype(np.float32)))
    return x.to(device, dtype), [w.to(device, dtype) for w in ws]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 37, 45, 32), (1, 16, 16, 64), (3, 5, 70, 32)])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    x, ws = _block_inputs(shape, dtype, cuda)
    before = dense_block.launches
    with true_f32():
        out = dense_block(x, *ws)
        ref = dense_block_reference(x, *ws)
    torch.cuda.synchronize()
    assert dense_block.launches == before + 5
    assert out.dtype == dtype and out.shape == x.shape
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 4 * 2.0**-8 * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_kernel_rejects_unsupported_input(cuda):
    x, ws = _block_inputs((1, 8, 8, 32), torch.float32, cuda)
    with pytest.raises(ValueError):
        dense_block(x[..., :16].contiguous(), *ws)
    with pytest.raises(TypeError):
        dense_block(x.half(), *[w.half() for w in ws])


@pytest.mark.gpu
def test_trained_sr_model_on_kernel_matches_cpu(cuda):
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    model = GeneratorRRDB_SR()
    model.load_state_dict(params_from_flax(PARAMS))
    with torch.inference_mode():
        ref = model(torch.from_numpy(x)).numpy()
        model.to(cuda)
        before = dense_block.launches
        with true_f32():
            out = model(torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert dense_block.launches == before + 60
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# K1 (space-to-depth dense block), P (int8 GEMM) and K3 (s8 convolution)
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 24, 40, 128), (1, 13, 21, 128), (1, 8, 16, 256)])
def test_k1_matches_plain_version(cuda, shape, dtype):
    x, flat = _block_inputs(shape, dtype, cuda)
    ws, bs = flat[0::2], flat[1::2]
    packed = pack_weights(ws, bs, dtype)
    before = dense_block_s2d.launches
    with true_f32():
        out = dense_block_s2d(x, packed, h_strip=shape[1], w_tile=shape[2])
        ref = dense_block_s2d_reference(x, ws, bs)
    torch.cuda.synchronize()
    assert dense_block_s2d.launches == before + 5
    assert out.dtype == dtype and out.shape == x.shape
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 4 * 2.0**-8 * ref.float().abs().max().item()
    assert err <= tol, (err, tol)


def _int8(shape, g):
    return torch.from_numpy(g.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [PROBE_SHAPE, (100, 64, 24), (300, 256, 136)])
def test_int8_gemm_is_exact(cuda, mkn):
    m, k, n = mkn
    g = np.random.default_rng(m)
    a, b = _int8((m, k), g), _int8((k, n), g)
    a[0], b[:, 0] = 127, -127
    before = int8_gemm.launches
    out = int8_gemm(a.to(cuda), b.to(cuda)).cpu()
    assert int8_gemm.launches == before + 1
    assert torch.equal(out, int8_gemm_reference(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,cin,cout,prefix", [
    (2, 13, 21, 4, 128, None),  # conv_first: Cin 4 padded to 32
    (1, 16, 16, 384, 128, 640),  # a dense level reading a concat prefix in place
    (1, 9, 17, 128, 512, None),  # upconv
    (2, 8, 16, 640, 128, None),
])
def test_conv_i8_is_exact(cuda, b, h, w, cin, cout, prefix):
    g = np.random.default_rng(cin)
    full = _int8((b, h, w, prefix or cin), g)
    full[0, :2, :2] = 127
    w8 = _int8((3, 3, cin, cout), g)
    w8[..., 0] = 127
    x8 = full.to(cuda)[..., :cin]
    before = conv_i8.launches
    out = conv_i8(x8, w8.to(cuda)).cpu()
    assert conv_i8.launches == before + 1
    assert torch.equal(out, conv_i8_reference(full[..., :cin], w8))


@pytest.mark.gpu
def test_new_kernels_refuse_unsupported_input(cuda):
    x, flat = _block_inputs((1, 8, 8, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="128"):
        dense_block_s2d(x, flat[0::2], flat[1::2], h_strip=8, w_tile=8)
    with pytest.raises(TypeError):
        dense_block_s2d(x.half(), [w.half() for w in flat[0::2]], [b.half() for b in flat[1::2]],
                        h_strip=8, w_tile=8)
    g = np.random.default_rng(0)
    with pytest.raises(ValueError, match="K % 32"):
        int8_gemm(_int8((64, 48), g).to(cuda), _int8((48, 8), g).to(cuda))
    with pytest.raises(ValueError):
        conv_i8(_int8((1, 8, 8, 32), g).to(cuda), _int8((3, 3, 32, 64), g).to(cuda))
    with pytest.raises(ValueError):
        conv_i8(_int8((1, 16, 8, 32), g).to(cuda)[:, ::2], _int8((3, 3, 32, 128), g).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_s2d_and_fast_forwards_on_the_kernels_match_cpu(cuda, dtype):
    from xmm_superres_denoise_torch.ops.dense_block import make_fast_rrdb_forward
    from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_sr_forward

    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    model = GeneratorRRDB_SR()
    # f32: summation order only; bf16 against the f32 CPU forward: 4 bf16
    # ulps at the top of the [0, 1] output range
    atol = 1e-5 if dtype == torch.float32 else 4 * 2.0**-8
    with torch.inference_mode():
        ref = make_s2d_sr_forward(model, PARAMS, torch.float32, device="cpu")(torch.from_numpy(x))
        for make, counter in ((make_s2d_sr_forward, dense_block_s2d), (make_fast_rrdb_forward, dense_block)):
            fwd = make(model, PARAMS, dtype, device=cuda)
            before = counter.launches
            out = fwd(torch.from_numpy(x).to(cuda)).float().cpu()
            assert counter.launches == before + 60
            print(f"{make.__name__} {dtype}: max|card - cpu f32| "
                  f"{(out - ref).abs().max().item():.3e} (atol {atol:.1e})")
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=atol)


@pytest.mark.gpu
def test_int8_forward_on_k3_matches_cpu(cuda):
    from xmm_superres_denoise_torch.ops.int8_forward import calibrate_int8_scales, make_int8_s2d_forward

    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    model = GeneratorRRDB_SR()
    scales = calibrate_int8_scales(model, PARAMS, x, device="cpu")
    with torch.inference_mode():
        ref = make_int8_s2d_forward(model, PARAMS, dtype=torch.float32, scales=scales,
                                    device="cpu")(torch.from_numpy(x))
        fwd = make_int8_s2d_forward(model, PARAMS, dtype=torch.float32, scales=scales, device=cuda)
        before = conv_i8.launches
        out = fwd(torch.from_numpy(x).to(cuda)).cpu()
    assert conv_i8.launches == before + 64
    # the int32 sums are exact on both; the f32 epilogues differ by an ulp
    # at most, which can flip a code at a rounding tie
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-3)
