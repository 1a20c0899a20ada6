"""The port's int8 serving (`xmm_superres_denoise_torch/ops/int8_forward.py`,
`ops/conv_i8.py`, `ops/int8_gemm.py` and `InferenceEngine(quantize=True)`)
against the JAX package's, on the CPU.

Integer work must be bitwise equal: the quantised weights, the int32 sums of
the convolution (the port's plain version is a float64 convolution, exact
at these magnitudes) and of the probe product, and the int8 codes the
forward feeds its first dense level. Scales are max-abs of f32 activations
summed in another order: rtol 1e-5. The forwards are compared on the same
scales dict: <= 1e-3 on the [0, 1] output scale (an int8 code that flips at
a rounding tie moves the output by a fraction of a quantisation step).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.config import schema as tcfg
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops import int8_forward as ti8
from xmm_superres_denoise_torch.ops.conv_i8 import conv_i8, conv_i8_reference, pack_weights
from xmm_superres_denoise_torch.ops.int8_gemm import int8_gemm, int8_gemm_reference
from xmm_superres_denoise_torch.utils.weights import flax_tree, params_from_flax
from xmm_superres_denoise_tpu import config as jcfg
from xmm_superres_denoise_tpu import models as jmodels
from xmm_superres_denoise_tpu.infer.run_file import InferenceEngine as JaxEngine
from xmm_superres_denoise_tpu.ops import int8_forward as ji8

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"
LR_MAX, SR_HR_MAX = 0.0022336, 0.0005584
FWD_ATOL = 1e-3


@pytest.fixture(scope="module")
def tree():
    out: dict = {}
    with np.load(PARAMS) as npz:
        for key in npz.files:
            node = out
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(npz[key])
    return out


@pytest.fixture(scope="module")
def calib():
    return np.random.default_rng(11).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def scales(tree, calib):
    return ji8.calibrate_int8_scales(jmodels.GeneratorRRDB_SR(num_upsample=1), tree,
                                     jnp.asarray(calib))


@pytest.mark.parametrize("group,scales_", [(8, [0.5, 2.0, 0.125]), (4, [3.0]), (128, [0.7, 1e-6])])
def test_quant_weights_grouped_bitwise_equal(group, scales_):
    g = np.random.default_rng(group)
    w = (g.normal(size=(3, 3, group * len(scales_), 16)) * 0.2).astype(np.float32)
    w[0, 0, 0, 0] = 0.0
    w8, c_o = ti8._quant_weights_grouped(w, scales_, group)
    jw8, jc_o = ji8._quant_weights_grouped(w, scales_, group)
    assert w8.dtype == np.int8 and c_o.dtype == np.float32
    np.testing.assert_array_equal(w8, np.asarray(jw8))
    np.testing.assert_array_equal(c_o, np.asarray(jc_o))


@pytest.mark.parametrize("cin,cout", [(4, 128), (64, 16), (640, 8)])
def test_conv_i8_plain_version_equals_xla_int8_conv(cin, cout):
    g = np.random.default_rng(cin)
    x8 = g.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w8 = g.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    x8[0, :3, :3] = 127  # extremes: the largest sums there are
    w8[:, :, :, 0] = 127
    x8[1, -3:, -3:] = -127
    want = np.asarray(ji8._conv_i8(jnp.asarray(x8), jnp.asarray(w8)))
    got = conv_i8(torch.from_numpy(x8), torch.from_numpy(w8))
    assert got.dtype == torch.int32
    print(f"conv_i8 {cin}->{cout}: max|port - xla| {np.abs(got.numpy() - want).max()}, "
          f"max|sum| {np.abs(want).max()}")
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(conv_i8(torch.from_numpy(x8), pack_weights(w8)), got)


def test_conv_i8_reads_a_channel_prefix_in_place():
    g = np.random.default_rng(3)
    buf = torch.from_numpy(g.integers(-127, 128, (1, 6, 7, 96)).astype(np.int8))
    w8 = torch.from_numpy(g.integers(-127, 128, (3, 3, 64, 8)).astype(np.int8))
    assert torch.equal(conv_i8(buf[..., :64], w8), conv_i8_reference(buf[..., :64].contiguous(), w8))


def test_int8_gemm_plain_version_equals_numpy_int64():
    g = np.random.default_rng(0)
    a = g.integers(-127, 128, (2048, 128)).astype(np.int8)
    b = g.integers(-127, 128, (128, 128)).astype(np.int8)
    a[0] = 127
    b[:, 0] = 127
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert got.dtype == torch.int32 and int(np.abs(want).max()) == 128 * 127 * 127
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(int8_gemm_reference(torch.from_numpy(a), torch.from_numpy(b)), got)


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "dn"])
def test_calibrated_scales_match_jax(tree, calib, scales, sr):
    if sr:
        want, params, model = scales, PARAMS, GeneratorRRDB_SR()
    else:
        model = GeneratorRRDB_DN(num_filters=8, num_res_blocks=2)
        model.reset_parameters(torch.Generator().manual_seed(0))
        params = flax_tree(model.state_dict())  # seeded weights, the same for both
        jmodel = jmodels.GeneratorRRDB_DN(num_filters=8, num_res_blocks=2)
        want = ji8.calibrate_int8_scales(jmodel, params, jnp.asarray(calib))
    got = ti8.calibrate_int8_scales(model, params, calib, device="cpu")
    assert sorted(got) == sorted(want)
    rel = max(abs(got[k] - want[k]) / want[k] for k in want)
    print(f"{'SR' if sr else 'DN'}: {len(got)} scale keys, max rel diff {rel:.3e}")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def _recording(monkeypatch, module):
    """Record every int8 tensor `module._quantize` returns."""
    codes, real = [], module._quantize

    def rec(x, scale):
        q = real(x, scale)
        codes.append(np.asarray(q))
        return q

    monkeypatch.setattr(module, "_quantize", rec)
    return codes


@pytest.mark.parametrize("concat_free", [False, True], ids=["concat", "concat_free"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_forward_matches_jax_on_the_same_scales(tree, calib, scales, dtype, concat_free,
                                                     monkeypatch):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(12).uniform(0, 1, (1, 16, 16, 1)).astype(np.float32)
    jcodes = _recording(monkeypatch, ji8)
    jfwd = ji8.make_int8_s2d_forward(jmodels.GeneratorRRDB_SR(num_upsample=1), tree,
                                     dtype=jdt, scales=scales, concat_free=concat_free)
    want = np.asarray(jfwd(jnp.asarray(x)).astype(jnp.float32))
    tcodes = _recording(monkeypatch, ti8)
    tfwd = ti8.make_int8_s2d_forward(GeneratorRRDB_SR(), PARAMS, dtype=tdt, scales=scales,
                                     concat_free=concat_free, device="cpu")
    got = tfwd(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (1, 32, 32, 1)
    got = got.float().numpy()
    assert len(tcodes) == len(jcodes) == 1 + 12 * 5 + 1 + 2
    same = [np.array_equal(a, b) for a, b in zip(tcodes, jcodes)]
    flips = sum(int((a != b).sum()) for a, b in zip(tcodes, jcodes))
    err = np.abs(got - want).max()
    print(f"int8 {dtype} {'concat-free' if concat_free else 'concat'}: max|port - jax| "
          f"{err:.3e}; int8 code tensors bitwise equal {sum(same)}/{len(same)}, "
          f"codes differing {flips} of {sum(c.size for c in jcodes)}")
    # conv_first's input, the first dense block's input and its level-1 codes
    assert all(same[:3])
    assert err <= FWD_ATOL


def test_quantization_psnr_gate():
    x = np.random.default_rng(13).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    psnr = ti8.quantization_psnr(GeneratorRRDB_SR(), PARAMS, x, device="cpu")
    print(f"int8 vs f32 PSNR, trained esr_gen, 2x32^2: {psnr:.2f} dB")
    assert psnr >= 40.0


def test_int8_forward_requires_calib_or_scales_and_full_scales():
    with pytest.raises(ValueError, match="calibration"):
        ti8.make_int8_s2d_forward(GeneratorRRDB_SR(), PARAMS, device="cpu")
    with pytest.raises(ValueError, match="lack"):
        ti8.make_int8_s2d_forward(GeneratorRRDB_SR(), PARAMS, scales={"conv_first": 1.0},
                                  device="cpu")


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

RES, NATIVE = 32, (30, 29)


def _dataset(mod):
    return mod.DatasetCfg(
        lr=mod.LrDatasetCfg(bkg=0, exps=[20], clamp_max=LR_MAX, res=RES),
        hr=mod.HrDatasetCfg(exp=100, clamp_max=SR_HR_MAX, res=2 * RES),
        scaling="sqrt", type="boring",
    )


def _jax_engine(tree, **kw):
    model = jcfg.ModelCfg(name="esr_gen", model=jcfg.RrdbCfg(base_model="esr_gen"),
                          optimizer=jcfg.OptimizerCfg(learning_rate=1e-4))
    return JaxEngine(model, _dataset(jcfg), tree, **kw)


def _port_engine(**kw):
    return InferenceEngine(tcfg.ModelCfg(name="esr_gen", model={"base_model": "esr_gen"}),
                           _dataset(tcfg), params_from_flax(PARAMS), device="cpu", **kw)


def _psnr(a, b):
    """PSNR (dB) of two products on the hr clamp_max scale."""
    return float(10 * np.log10(1.0 / max(np.mean(((a - b) / SR_HR_MAX) ** 2), 1e-30)))


def test_int8_engine_matches_jax_and_scales_round_trip(tree, tmp_path):
    # The prepared inputs agree to an f32 ulp, not bitwise (the JAX engine
    # runs under jit); an ulp at a rounding tie flips an int8 code, and a
    # flipped code moves the product within the int8 class. So the engines
    # are held to the int8 gate (>= 40 dB, tests/test_int8_forward.py)
    # against each other; the forwards themselves agree to 1e-3 on the same
    # input (test_int8_forward_matches_jax_on_the_same_scales).
    raw = np.random.default_rng(14).uniform(0, 2e-3, (2, *NATIVE)).astype(np.float32)
    jax_engine = _jax_engine(tree, quantize=True)
    port_engine = _port_engine(quantize=True)
    assert port_engine.int8_scales is None
    want, want_inp = jax_engine(raw)
    got, got_inp = port_engine(raw)
    np.testing.assert_allclose(got_inp, want_inp, rtol=0, atol=1e-6 * LR_MAX)
    js, ts = jax_engine.int8_scales, port_engine.int8_scales
    assert sorted(js) == sorted(ts)
    for k in js:
        assert ts[k] == pytest.approx(js[k], rel=1e-5), k
    psnr = _psnr(got, want)
    print(f"int8 engine, lr.res {RES}: max|port - jax| {np.abs(got - want).max() / SR_HR_MAX:.3e}"
          f" x hr_max, PSNR {psnr:.2f} dB, {len(ts)} scale keys")
    assert psnr >= 40.0

    # each package serves from the other's scales JSON, and the port from
    # its own JSON exactly as after its lazy calibration
    (tmp_path / "port.json").write_text(json.dumps(ts))
    (tmp_path / "jax.json").write_text(json.dumps(js))
    from_jax = _port_engine(quantize=True,
                            int8_scales=json.loads((tmp_path / "jax.json").read_text()))
    from_port = _jax_engine(tree, quantize=True,
                            int8_scales=json.loads((tmp_path / "port.json").read_text()))
    own = _port_engine(quantize=True, int8_scales=json.loads((tmp_path / "port.json").read_text()))
    assert from_jax.int8_scales == js and own.int8_scales == ts
    np.testing.assert_array_equal(own(raw)[0], got)
    assert _psnr(from_jax(raw)[0], want) >= 40.0
    assert _psnr(from_port(raw)[0], got) >= 40.0


def test_int8_engine_refuses_a_non_rrdb_model_and_scales_without_quantize():
    with pytest.raises(ValueError, match="quantize=True"):
        _port_engine(int8_scales={"conv_first": 1.0})
    with pytest.raises(ValueError):
        ti8.make_int8_s2d_forward(torch.nn.Conv2d(1, 1, 3), {}, scales={}, device="cpu")
