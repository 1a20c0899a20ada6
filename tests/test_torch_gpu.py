"""Card-only tests of the port: the CUDA dense-block kernel against its plain
version, and the model and engine through the kernel.

Every test here is marked `gpu` and skips without a CUDA card; whether a card
is present is decided inside the `cuda` fixture, never at import. This file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Tolerances: f32 with TF32 off differs from cuDNN only in summation order
(atol 1e-4 on O(1) activations); bf16 stores each level in bf16 in both
versions, so they may differ by a few bf16 ulps (2^-8 relative).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops.dense_block import dense_block, dense_block_reference
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
