"""The port's stretch, normalization and geometry ops against the JAX
package's, elementwise on the same numpy inputs, plus the TF32 switch.

Tolerance: rtol 1e-6 / atol 1e-7, a few f32 ulps (the transcendental
functions of the two libraries round differently in the last bit).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmm_superres_denoise_torch.ops import preprocess as tp
from xmm_superres_denoise_torch.ops import stretch as ts
from xmm_superres_denoise_torch.ops.precision import true_f32
from xmm_superres_denoise_tpu.ops.stretch import Normalizer as JaxNormalizer
from xmm_superres_denoise_tpu.ops.stretch import destretch as jax_destretch
from xmm_superres_denoise_tpu.ops.stretch import stretch as jax_stretch

# the JAX ops package re-exports a function named `preprocess`, which hides
# the module of that name from `from ... import`
jp = importlib.import_module("xmm_superres_denoise_tpu.ops.preprocess")

TOL = dict(rtol=1e-6, atol=1e-7)
MODES = ["linear", "sqrt", "log", "asinh"]


@pytest.fixture(scope="module")
def unit():
    return np.random.default_rng(0).uniform(0, 1, (3, 40, 37)).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_stretch_and_inverse_match_jax(unit, mode):
    x = torch.from_numpy(unit)
    np.testing.assert_allclose(
        ts.stretch(x, mode).numpy(), np.asarray(jax_stretch(jnp.asarray(unit), mode)), **TOL
    )
    np.testing.assert_allclose(
        ts.destretch(x, mode).numpy(), np.asarray(jax_destretch(jnp.asarray(unit), mode)), **TOL
    )
    np.testing.assert_allclose(ts.destretch(ts.stretch(x, mode), mode).numpy(), unit,
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("mode", MODES)
def test_normalizer_matches_jax(mode):
    g = np.random.default_rng(1)
    rates = g.uniform(-1e-4, 3e-3, (2, 24, 24)).astype(np.float32)  # spans both clamps
    unit = g.uniform(-0.1, 1.1, (2, 24, 24)).astype(np.float32)
    ours = ts.Normalizer(lr_max=0.0022336, hr_max=0.0005584, mode=mode)
    ref = JaxNormalizer(lr_max=0.0022336, hr_max=0.0005584, mode=mode)
    for fn, arr in (("normalize_lr", rates), ("normalize_hr", rates),
                    ("denormalize_lr", unit), ("denormalize_hr", unit)):
        got = getattr(ours, fn)(torch.from_numpy(arr)).numpy()
        want = np.asarray(getattr(ref, fn)(jnp.asarray(arr)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-9, err_msg=fn)


def test_unknown_stretch_mode_raises():
    with pytest.raises(ValueError, match="Unknown stretch mode"):
        ts.stretch(torch.zeros(2), "gamma")


@pytest.mark.parametrize("shape,res", [((411, 403), 416), ((2, 60, 57), 64), ((64, 64), 64)])
def test_pad_to_res_matches_jax(shape, res):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = tp.pad_to_res(torch.from_numpy(x), res).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.pad_to_res(jnp.asarray(x), res)))


def test_pad_to_res_refuses_to_crop():
    with pytest.raises(ValueError, match="only pads"):
        tp.pad_to_res(torch.zeros(70, 60), 64)


@pytest.mark.parametrize("mode", ["center", "boresight"])
@pytest.mark.parametrize("crop_p", [1.0, 0.75, 0.5])
def test_crop_matches_jax(mode, crop_p):
    x = np.random.default_rng(3).normal(size=(2, 64, 64)).astype(np.float32)
    frac = tp.crop_fractions(mode, crop_p)
    assert frac == jp.crop_fractions(mode, crop_p)
    got = tp.crop(torch.from_numpy(x), crop_p, *frac).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.crop(jnp.asarray(x), crop_p, *frac)))


def test_random_crop_fractions_follow_the_generator():
    a = tp.crop_fractions("random", 0.5, rng=np.random.default_rng(7))
    b = jp.crop_fractions("random", 0.5, rng=np.random.default_rng(7))
    assert a == b and all(0.0 <= f <= 0.5 for f in a)
    with pytest.raises(ValueError, match="Unknown crop mode"):
        tp.crop_fractions("corner", 0.5)


def test_true_f32_turns_tf32_off_for_conv_and_matmul_and_restores():
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with true_f32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(RuntimeError):
            with true_f32():
                raise RuntimeError("boom")
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul
