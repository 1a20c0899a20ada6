"""K3's fused epilogue (`xmm_superres_denoise_torch/ops/conv_i8.py`:
`Epilogue`, `conv_i8(..., epilogue)`) on the CPU, where it runs its plain
version, against the op sequence it replaces and against the JAX package.

Each variant is one convolution of the int8 forward with its epilogue:
dense levels 1-4 (LeakyReLU 0.2, then the next level's int8 codes written
into the concat slice), level 5 (0.2 * y + x0), conv_first (Cin 4),
trunk_conv (fea + y), upconv (LeakyReLU 0.01, 512 channels) and HRconv
(LeakyReLU 0.2), and level 5, conv_first and trunk_conv writing their
values and, beside them, the codes of the next convolution's input, in
f32 and bf16, at 2 x 13 x 21 px.

* The plain version equals the composition written out here from
  `conv_i8_reference`, the dequantisation, `lrelu`, the residual and the
  int8 forward's `_quantize`: bitwise.
* It matches the JAX expression it replaces (`ji8._conv_i8` and the jnp
  epilogue of `xmm_superres_denoise_tpu/ops/int8_forward.py: forward`) on
  the same numpy-seeded inputs: int8 codes equal except at rounding ties
  (at most 1 code in 1,000, each off by one), dtype values within 4 f32
  ulps (f32) or 1 bf16 ulp (bf16).
* The wrapper's argument checks refuse what neither version can take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.ops import conv_i8 as k3
from xmm_superres_denoise_torch.ops import int8_forward as ti8
from xmm_superres_denoise_torch.ops.conv_i8 import Epilogue, conv_i8, conv_i8_reference, pack_weights
from xmm_superres_denoise_tpu.ops import int8_forward as ji8

GROUP = 128  # the S2D concat group at esr_gen width
SENTINEL = -128  # never an int8 code (codes are clipped to +-127)
CODE_FLIP_LIMIT = 1e-3  # share of codes that may differ from JAX's, at ties
F32_ULPS, BF16_ULPS = 4, 1

# name: (cin, cout, concat level or None, slope, res_scale, requantise,
# values beside the codes)
VARIANTS = {
    "level1": (128, 128, 1, 0.2, None, True, False),
    "level2": (256, 128, 2, 0.2, None, True, False),
    "level3": (384, 128, 3, 0.2, None, True, False),
    "level4": (512, 128, 4, 0.2, None, True, False),
    "level5": (640, 128, None, None, 0.2, False, True),
    "conv_first": (4, 128, None, None, None, False, True),
    "trunk_conv": (128, 128, None, None, 1.0, False, True),
    "upconv": (128, 512, None, 0.01, None, False, True),
    "hrconv": (128, 128, None, 0.2, None, False, True),
    "level5+codes": (640, 128, None, None, 0.2, True, True),
    "conv_first+codes": (4, 128, None, None, None, True, True),
    "trunk_conv+codes": (128, 128, None, None, 1.0, True, True),
}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _case(name, dtype):
    """Seeded inputs of one variant: (x8 (a prefix of the concat for a
    level), w8, c_o, bias, residual, qscale, concat buffer or None)."""
    cin, cout, level, slope, res_scale, requant, _ = VARIANTS[name]
    g = np.random.default_rng(sum(map(ord, name)))
    b, h, w = 2, 13, 21
    if level is None:
        buf = None
        x8 = torch.from_numpy(g.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
    else:
        buf = torch.full((b, h, w, 5 * GROUP), SENTINEL, dtype=torch.int8)
        buf[..., :cin] = torch.from_numpy(g.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
        x8 = buf[..., :cin]
    w8 = torch.from_numpy(g.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))
    # c_o puts the dequantised values at O(1), as the calibrated forward does
    c_o = (g.uniform(0.5, 2.0, cout) / (np.sqrt(9 * cin) * 73.0**2)).astype(np.float32)
    bias = (g.normal(size=cout) * 0.1).astype(np.float32)
    residual = None
    if res_scale is not None:
        residual = torch.from_numpy(g.normal(size=(b, h, w, cout)).astype(np.float32)).to(dtype)
    qscale = float(g.uniform(2.0, 4.0)) if requant else None
    return x8, w8, torch.from_numpy(c_o), torch.from_numpy(bias), residual, qscale, buf


def _epilogue(name, dtype, c_o, bias, qscale):
    _, _, _, slope, res_scale, _, values = VARIANTS[name]
    return Epilogue(c_o, bias, dtype, slope=slope, res_scale=res_scale, qscale=qscale,
                    values=values)


def _codes_slice(name, buf):
    level = VARIANTS[name][2]
    return None if level is None else buf[..., level * GROUP : (level + 1) * GROUP]


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_plain_version_is_the_written_out_composition(name, dtype):
    tdt = DTYPES[dtype][0]
    x8, w8, c_o, bias, residual, qscale, buf = _case(name, tdt)
    _, _, level, slope, res_scale, _, values = VARIANTS[name]
    y32 = conv_i8_reference(x8.contiguous(), w8)
    want = (y32.float() * c_o + bias).to(tdt)
    if slope is not None:
        want = torch.where(want >= 0, want, want * torch.tensor(slope, dtype=tdt))
    if res_scale is not None:
        want = want * torch.tensor(res_scale, dtype=tdt) + residual
    if qscale is not None:
        want = (want, ti8._quantize(want, qscale)) if values else ti8._quantize(want, qscale)
    before = None if buf is None else buf.clone()
    got = conv_i8(x8, pack_weights(w8), _epilogue(name, tdt, c_o, bias, qscale), residual=residual,
                  codes=_codes_slice(name, buf))
    if isinstance(want, tuple):
        assert [t.dtype for t in got] == [tdt, torch.int8]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert got.dtype == (torch.int8 if qscale is not None else tdt)
        assert torch.equal(got, want)
    if buf is not None:  # written in place into its slice, the rest untouched
        assert got.data_ptr() == _codes_slice(name, buf).data_ptr()
        lo, hi = level * GROUP, (level + 1) * GROUP
        assert torch.equal(buf[..., :lo], before[..., :lo])
        assert torch.equal(buf[..., hi:], before[..., hi:])
        assert bool((buf[..., hi:] == SENTINEL).all())


def _ulps(got: np.ndarray, want: np.ndarray, dtype: str) -> float:
    """max |got - want| in units of want's ulp in `dtype`."""
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    if dtype == "bf16":  # 7 stored mantissa bits instead of 23
        ulp *= 2.0**16
    return float((np.abs(got.astype(np.float64) - want.astype(np.float64)) / ulp).max())


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_plain_version_matches_the_jax_epilogue(name, dtype):
    tdt, jdt = DTYPES[dtype]
    x8, w8, c_o, bias, residual, qscale, buf = _case(name, tdt)
    _, _, _, slope, res_scale, _, values = VARIANTS[name]
    # the JAX package's expression (int8_forward.py: forward), op by op
    jy = (ji8._conv_i8(jnp.asarray(x8.contiguous().numpy()), jnp.asarray(w8.numpy()))
          .astype(jnp.float32) * jnp.asarray(c_o.numpy()) + jnp.asarray(bias.numpy())).astype(jdt)
    if slope is not None:
        jy = ji8._lrelu(jy, slope)
    if res_scale == 1.0:  # trunk_conv: fea + trunk
        jy = jnp.asarray(residual.float().numpy()).astype(jdt) + jy
    elif res_scale is not None:  # level 5: y * dtype(0.2) + x0
        jy = jy.astype(jdt) * jdt(res_scale) + jnp.asarray(residual.float().numpy()).astype(jdt)
    got = conv_i8(x8, pack_weights(w8), _epilogue(name, tdt, c_o, bias, qscale), residual=residual,
                  codes=_codes_slice(name, buf))
    if qscale is None:
        got8 = None
    elif values:
        got, got8 = got
    else:
        got, got8 = None, got
    if got8 is not None:
        want = np.asarray(ji8._quantize(jy, qscale)).astype(np.int32)
        diff = np.abs(got8.numpy().astype(np.int32) - want)
        flips = int((diff != 0).sum())
        print(f"{name} {dtype}: int8 codes differing from JAX {flips} of {want.size} "
              f"(limit {CODE_FLIP_LIMIT:.0e} of them, each by at most 1)")
        assert diff.max() <= 1 and flips <= CODE_FLIP_LIMIT * want.size
    if got is not None:
        want = np.asarray(jy.astype(jnp.float32))
        ulps = _ulps(got.float().numpy(), want, dtype)
        limit = F32_ULPS if dtype == "f32" else BF16_ULPS
        print(f"{name} {dtype}: max|port - jax| {np.abs(got.float().numpy() - want).max():.3e} "
              f"= {ulps:.2f} {dtype} ulps (limit {limit})")
        assert ulps <= limit


def test_epilogue_scalars_are_rounded_as_torch_rounds_them():
    c_o, bias = torch.ones(128), torch.zeros(128)
    bf = Epilogue(c_o, bias, torch.bfloat16, slope=0.2, res_scale=0.2, qscale=3.0)
    f32 = Epilogue(c_o, bias, torch.float32, slope=0.01, res_scale=1.0, qscale=3.0)
    assert bf.kernel_scalars == (0.2001953125, 0.2001953125, float(np.float32(127.0 / 3.0)))
    assert f32.kernel_scalars == (float(np.float32(0.01)), 1.0, float(np.float32(127.0 / 3.0)))
    assert not bf.values and not f32.values  # codes only
    assert Epilogue(c_o, bias, torch.bfloat16).values  # no requantisation: the values
    assert Epilogue(c_o, bias, torch.float32).kernel_scalars == (0.0, 0.0, 0.0)


def test_routes():
    assert [k3.route(c) for c in (4, 32, 64, 96, 128, 384, 640)] == \
        ["wgmma_taps", "wgmma_taps", "wgmma_taps", "wgmma_taps", "wgmma", "wgmma", "wgmma"]


def test_wrapper_refuses_what_it_cannot_take():
    g = np.random.default_rng(0)
    x8 = torch.from_numpy(g.integers(-127, 128, (1, 6, 7, 128)).astype(np.int8))
    w8 = pack_weights(torch.from_numpy(g.integers(-127, 128, (3, 3, 128, 128)).astype(np.int8)))
    epi = Epilogue(torch.ones(128), torch.zeros(128), torch.bfloat16, res_scale=0.2)
    res = torch.zeros(1, 6, 7, 128, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        Epilogue(torch.ones(128), torch.zeros(128), torch.float16)
    with pytest.raises(ValueError, match=r"\(Cout,\)"):
        Epilogue(torch.ones(128), torch.zeros(64), torch.float32)
    with pytest.raises(ValueError, match="residual exactly"):
        conv_i8(x8, w8, epi)
    with pytest.raises(ValueError, match="residual exactly"):
        conv_i8(x8, w8, residual=res)
    with pytest.raises(ValueError, match="residual must be"):
        conv_i8(x8, w8, epi, residual=res.float())
    with pytest.raises(ValueError, match="residual must be"):
        conv_i8(x8, w8, epi, residual=res[:, :5])
    with pytest.raises(ValueError, match="out must be"):
        conv_i8(x8, w8, epi, residual=res, out=torch.empty(1, 6, 7, 128, dtype=torch.float32))
    with pytest.raises(ValueError, match="out must be"):
        conv_i8(x8, w8, out=torch.empty(1, 6, 7, 128, dtype=torch.int8))
    with pytest.raises(ValueError, match="epilogue has 64 channels"):
        conv_i8(x8, w8, Epilogue(torch.ones(64), torch.zeros(64), torch.float32))
    with pytest.raises(ValueError, match="shares memory"):
        conv_i8(x8, w8, epi, residual=res, out=res)
    codes = Epilogue(torch.ones(128), torch.zeros(128), torch.bfloat16, qscale=3.0)
    with pytest.raises(ValueError, match="writes no codes"):
        conv_i8(x8, w8, epi, residual=res, codes=torch.empty(1, 6, 7, 128, dtype=torch.int8))
    with pytest.raises(ValueError, match="writes no out"):  # codes only
        conv_i8(x8, w8, codes, out=torch.empty(1, 6, 7, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="codes must be"):
        conv_i8(x8, w8, codes, codes=torch.empty(1, 6, 7, 128, dtype=torch.int32))
    assert conv_i8(x8, w8, codes).dtype == torch.int8
    assert conv_i8(x8, w8, epi, residual=res).dtype == torch.bfloat16


def test_output_layout_checks():
    # what the card's launch refuses: uneven or odd pixel strides, a base off
    # a pair boundary, and an output over the input channels it reads
    buf = torch.zeros(1, 4, 4, 640, dtype=torch.int8)
    assert k3._pair_stride(buf[..., 128:256], "output") == 640
    for bad in (buf[..., 129:257], buf[:, ::2, :, :128],
                torch.zeros(1, 4, 4, 129, dtype=torch.int8)[..., :128]):
        with pytest.raises(ValueError, match="cannot take this output"):
            k3._pair_stride(bad, "output")
    flat = torch.zeros(2 * 4 * 4 * 128 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte boundary"):
        k3._pair_stride(flat[1:].view(2, 4, 4, 128), "residual")
    k3._check_apart(buf[..., :256], buf[..., 256:384])
    k3._check_apart(buf[..., 128:256], buf[..., :128])  # before the prefix: disjoint too
    k3._check_apart(buf[..., :256], torch.zeros(1, 4, 4, 128, dtype=torch.int8))
    for out in (buf[..., 128:256], buf[..., 255:383], buf[..., :128]):
        with pytest.raises(ValueError, match="overlaps"):
            k3._check_apart(buf[..., :256], out)
