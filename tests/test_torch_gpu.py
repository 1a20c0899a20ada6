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

K2's bf16 levels run on the tensor cores in two kernels: C % 128 == 0
takes K1's level (wgmma fed by TMA, 16 x 16 pixels x 128 channels), any
other C % 32 == 0 an mma.sync 16 x 16 x 32 tile; the shapes below run both,
with ragged edges. The f32 levels of both blocks run one CUDA-core kernel
(`csrc/conv3x3_f32.cuh`), 128 or 32 channels per block; its level tests
cover both widths, ragged edges, and tile counts below and far above the
resident blocks of its persistent grid.

K3 runs at Cin % 128 == 0 the s8 twin of K1's wgmma level and otherwise
(conv_first) the mma.sync Tile128, both with the int8 forward's epilogue
inside: each fused variant must equal, bit for bit, its plain composition
(the float64 convolution and the torch epilogue) run on the card.

Training and evaluation: the full-width model's 130 parameter gradients
through K2 (the dense block's autograd route) against the CPU model's, in
f32 within 1e-4 x max|g| and in bf16 finite; the inference-only kernels'
refusal of a gradient; the metric collections on the card against float64
on the CPU (1e-4 relative, FSIM 5e-4); the data module's loader on the card
against the same loader on the CPU.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops import cuda_build
from xmm_superres_denoise_torch.ops import conv_i8 as k3
from xmm_superres_denoise_torch.ops.conv_i8 import Epilogue, conv_i8, conv_i8_reference
from xmm_superres_denoise_torch.ops.dense_block import (
    dense_block,
    dense_block_reference,
    pack_weights,
)
from xmm_superres_denoise_torch.ops.dense_block import level_kernel
from xmm_superres_denoise_torch.ops.dense_block_s2d import (
    _SIGNATURES as _S2D_SIGNATURES,
    dense_block_s2d,
    dense_block_s2d_reference,
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
@pytest.mark.parametrize("shape", [(2, 37, 45, 32), (1, 16, 16, 64), (3, 5, 70, 32),
                                   (1, 19, 21, 96), (2, 24, 40, 128)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [32, 96, 128])
def test_kernel_packed_block_equals_raw_weights(cuda, c, dtype):
    x, ws = _block_inputs((2, 17, 33, c), dtype, cuda)
    packed = pack_weights(ws[0::2], ws[1::2], dtype)
    before = dense_block.launches
    a = dense_block(x, packed)
    b = dense_block(x, *ws)
    torch.cuda.synchronize()
    assert dense_block.launches == before + 10
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 24, 40, 128), (1, 13, 21, 256)])
def test_k2_bf16_at_c_multiple_of_128_is_k1s_level(cuda, shape):
    # the same tensor-core level kernel on the same inputs: equal bits
    x, ws = _block_inputs(shape, torch.bfloat16, cuda)
    packed = pack_weights(ws[0::2], ws[1::2], torch.bfloat16)
    k2 = dense_block(x, packed)
    k1 = dense_block_s2d(x, packed, h_strip=shape[1], w_tile=shape[2])
    torch.cuda.synchronize()
    assert torch.equal(k2, k1)


@pytest.mark.gpu
def test_bf16_kernel_rejects_unsupported_input(cuda):
    x, ws = _block_inputs((1, 8, 8, 64), torch.bfloat16, cuda)
    packed = pack_weights(ws[0::2], ws[1::2], torch.bfloat16)
    with pytest.raises(ValueError, match="C % 32"):
        dense_block(x[..., :16].contiguous(), *[w[..., :16] for w in ws])
    with pytest.raises(ValueError, match="contiguous"):
        dense_block(torch.zeros(1, 8, 8, 128, dtype=torch.bfloat16, device=cuda)[..., ::2], packed)
    with pytest.raises(ValueError, match="packed w"):
        dense_block(x, pack_weights(ws[0::2], ws[1::2], torch.float32)._replace(
            biases=packed.biases))
    with pytest.raises(ValueError, match="level 1"):
        dense_block(x, *[w.float() if i == 0 else w for i, w in enumerate(ws)])


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


@pytest.mark.gpu
def test_trained_sr_model_bf16_on_tensor_cores_tracks_cpu(cuda):
    # bf16 on the card (tensor-core levels) against bf16 on the CPU (plain
    # levels): the same one rounding per level, sums in another order, so
    # within 4 bf16 ulps at the top of the [0, 1] output range
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    model = GeneratorRRDB_SR()
    model.load_state_dict(params_from_flax(PARAMS))
    model.to(torch.bfloat16)
    with torch.inference_mode():
        ref = model(torch.from_numpy(x).bfloat16()).float().numpy()
        model.to(cuda)
        before = dense_block.launches
        out = model(torch.from_numpy(x).to(cuda, torch.bfloat16)).float().cpu().numpy()
        again = model(torch.from_numpy(x).to(cuda, torch.bfloat16)).float().cpu().numpy()
    assert dense_block.launches == before + 120
    err = np.abs(out - ref).max()
    print(f"model SR bf16: max|card - cpu| {err:.3e} (atol {4 * 2.0**-8:.3e})")
    assert err <= 4 * 2.0**-8
    np.testing.assert_array_equal(out, again)


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


def _level(buf, k, c, w, bias, dst, dst_stride, lib_name):
    """Launch one level k of `buf`'s dtype directly: K1's library (bf16 at
    C = 128) or K2's."""
    b, h, wd, stride = buf.shape
    args = (buf.data_ptr(), b, h, wd, stride, k * c, w.data_ptr(), bias.data_ptr(), c, dst,
            dst_stride, int(k == 5), cuda_build.stream_of(buf))
    if lib_name == "dense_block_s2d":
        lib = cuda_build.library(lib_name, _S2D_SIGNATURES)
        return lib, lib.dense_block_s2d_level(cuda_build.device_index(buf), *args)
    lib, level = level_kernel(buf.dtype)
    return lib, level(cuda_build.device_index(buf), *args)


def _levels_match_plain_version(cuda, shape, dtype, lib_name):
    """Each level k = 1..5 alone (cin = k*C) on a random concat buffer: one
    SAME 3x3 convolution in f32 plus bias, LeakyReLU into the buffer (k < 5)
    or 0.2 * v + x into the output (k = 5), rounded once to `dtype`. The
    output is NaN before the launch, so an unwritten pixel shows. bf16 is
    held to 4 bf16 ulps x max|plain|, f32 (summation order only) to
    1e-4 x max(1, max|plain|)."""
    b, h, w, c = shape
    g = np.random.default_rng(c + h)
    buf = torch.from_numpy(g.normal(size=(b, h, w, 5 * c)).astype(np.float32)).to(cuda, dtype)
    for k in range(1, 6):
        wk = torch.from_numpy((g.normal(size=(3, 3, k * c, c)) / np.sqrt(9 * k * c))
                              .astype(np.float32)).to(cuda, dtype)
        bk = torch.from_numpy((g.normal(size=(c,)) * 0.1).astype(np.float32)).to(cuda, dtype)
        packed = pack_weights([wk] * 5, [bk] * 5, dtype).kernel[0]
        with true_f32():
            y = F.conv2d(buf[..., : k * c].permute(0, 3, 1, 2).float(),
                         wk.float().permute(3, 2, 0, 1), bk.float(), padding=1)
        y = y * 0.2 + buf[..., :c].permute(0, 3, 1, 2).float() if k == 5 else F.leaky_relu(y, 0.2)
        ref = y.to(dtype).permute(0, 2, 3, 1)
        if k == 5:
            out = torch.full((b, h, w, c), float("nan"), dtype=dtype, device=cuda)
            lib, err = _level(buf, k, c, packed, bk, out.data_ptr(), c, lib_name)
        else:
            buf[..., k * c : (k + 1) * c] = float("nan")
            lib, err = _level(buf, k, c, packed, bk, buf[..., k * c :].data_ptr(), 5 * c, lib_name)
            out = buf[..., k * c : (k + 1) * c]
        cuda_build.check(lib, lib_name, err, f"level {k}")
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 4 * 2.0**-8 * scale if dtype == torch.bfloat16 else 1e-4 * max(1.0, scale)
        print(f"{shape} {dtype} level {k}: max|kernel - plain| {diff:.3e} (tol {tol:.3e})")
        assert bool(torch.isfinite(out).all()) and diff <= tol, (k, diff, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 208, 208, 128), (1, 13, 21, 128), (3, 37, 45, 128),
                                   (1, 13, 21, 256)])
def test_wgmma_level_matches_plain_version(cuda, shape):
    # C = 256 runs two channel groups through K2's library
    _levels_match_plain_version(cuda, shape, torch.bfloat16,
                                "dense_block_s2d" if shape[-1] == 128 else "dense_block")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 416, 416, 32),   # the model's block: 1352 tiles, many more than resident blocks
    (1, 13, 21, 32),     # 2 tiles, fewer than resident blocks; ragged
    (3, 37, 45, 32),     # ragged in both directions
    (2, 24, 40, 64),     # C = 64: two 32-channel groups
    (1, 13, 21, 128),    # one 128-channel group, ragged
    (2, 208, 208, 128),  # K1's and the fast forward's block: 338 tiles on one-block SMs
    (1, 13, 21, 256),    # two 128-channel groups
])
def test_f32_level_matches_plain_version(cuda, shape):
    # K1's f32 levels are K2's: one library serves both
    _levels_match_plain_version(cuda, shape, torch.float32, "dense_block")


@pytest.mark.gpu
def test_f32_level_refuses_misaligned_input(cuda):
    # the f32 level copies weights in 16-byte pieces and stores 16 bytes at
    # a time: the wrappers raise on a weight view 4 bytes past a boundary,
    # and the launch refuses a misaligned buffer; neither falls back
    x, ws = _block_inputs((1, 16, 16, 128), torch.float32, cuda)
    packed = pack_weights(ws[0::2], ws[1::2], torch.float32)
    w3 = packed.kernel[2]
    shifted = torch.empty(w3.numel() + 1, dtype=w3.dtype, device=cuda)[1:].view(w3.shape)
    shifted.copy_(w3)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    bad = packed._replace(kernel=packed.kernel[:2] + (shifted,) + packed.kernel[3:])
    s2d_before, k2_before = dense_block_s2d.launches, dense_block.launches
    with pytest.raises(ValueError, match="level 3.*16-byte"):
        dense_block_s2d(x, bad, h_strip=16, w_tile=16)
    with pytest.raises(ValueError, match="level 3.*16-byte"):
        dense_block(x, bad)
    raw = list(ws)
    raw[4] = shifted
    with pytest.raises(ValueError, match="level 3.*16-byte"):
        dense_block(x, *raw)
    assert (dense_block_s2d.launches, dense_block.launches) == (s2d_before, k2_before)
    buf = torch.zeros(1 * 16 * 16 * 640 + 4, dtype=torch.float32, device=cuda)
    view = buf[1:1 + 16 * 16 * 640].view(1, 16, 16, 640)
    out = torch.empty_like(x)
    lib, err = _level(view, 1, 128, packed.kernel[0], packed.biases[0], out.data_ptr(), 128,
                      "dense_block")
    with pytest.raises(RuntimeError, match="misaligned"):
        cuda_build.check(lib, "dense_block", err, "level 1")


def _sass_counts(lib_name, ops):
    """{kernel: {op: SASS lines}} of a built library, from cuobjdump."""
    path, _, _ = cuda_build.build(lib_name)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


@pytest.mark.gpu
def test_f32_level_is_ffma_only(cuda):
    # the f32 parity class has no TF32: the built f32 level kernels multiply
    # with FFMA and hold no tensor-core instruction (HMMA, HGMMA)
    counts = _sass_counts("dense_block", ("FFMA", "HMMA", "HGMMA"))
    f32 = {fn: c for fn, c in counts.items() if "conv3x3_f32_kernel" in fn}
    print(f32)
    assert len(f32) == 2  # the 32- and 128-channel blocks
    for c in f32.values():
        assert c["FFMA"] > 0 and c["HMMA"] == c["HGMMA"] == 0, c
    assert not any("dense_level_kernel" in fn for fn in counts)


@pytest.mark.gpu
def test_f32_kernel_takes_batches_past_the_bf16_grid_limit(cuda):
    # the f32 level launches a one-dimensional persistent grid, so B * C / 32
    # may pass 65535 (the bf16 levels' grid z); here 65,600 one-pixel images
    x, ws = _block_inputs((65600, 1, 1, 32), torch.float32, cuda)
    before = dense_block.launches
    with true_f32():
        out = dense_block(x, *ws)
        ref = dense_block_reference(x, *ws)
    torch.cuda.synchronize()
    assert dense_block.launches == before + 5
    assert (out - ref).abs().max().item() <= 1e-4
    with pytest.raises(ValueError, match="cannot take shape"):
        dense_block(x.bfloat16(), *[w.bfloat16() for w in ws])


@pytest.mark.gpu
def test_wgmma_level_refuses_misaligned_input(cuda):
    # TMA needs 16-byte-aligned bases: the wrappers raise on a weight view
    # that starts 2 bytes past a boundary, and the launch itself refuses a
    # misaligned buffer with an error; neither falls back
    x, ws = _block_inputs((1, 16, 16, 128), torch.bfloat16, cuda)
    packed = pack_weights(ws[0::2], ws[1::2], torch.bfloat16)
    w3 = packed.kernel[2]
    shifted = torch.empty(w3.numel() + 1, dtype=w3.dtype, device=cuda)[1:].view(w3.shape)
    shifted.copy_(w3)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    bad = packed._replace(kernel=packed.kernel[:2] + (shifted,) + packed.kernel[3:])
    s2d_before, k2_before = dense_block_s2d.launches, dense_block.launches
    with pytest.raises(ValueError, match="level 3.*16-byte"):
        dense_block_s2d(x, bad, h_strip=16, w_tile=16)
    with pytest.raises(ValueError, match="level 3.*16-byte"):
        dense_block(x, bad)
    assert (dense_block_s2d.launches, dense_block.launches) == (s2d_before, k2_before)
    buf = torch.zeros(1 * 16 * 16 * 640 + 8, dtype=torch.bfloat16, device=cuda)
    view = buf[1:1 + 16 * 16 * 640].view(1, 16, 16, 640)
    out = torch.empty_like(x)
    for lib_name in ("dense_block_s2d", "dense_block"):
        lib, err = _level(view, 1, 128, packed.kernel[0], packed.biases[0], out.data_ptr(), 128,
                          lib_name)
        with pytest.raises(RuntimeError, match="misaligned"):
            cuda_build.check(lib, lib_name, err, "level 1")


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
@pytest.mark.parametrize("b,h,w,cin,cout,width", [
    (2, 208, 208, 640, 128, 640),  # a dense block's level 5 at the serving shape
    (1, 13, 21, 128, 128, 128),    # ragged: 2 x 1 tiles, both partial
    (2, 37, 45, 384, 128, 640),    # a level reading a concat prefix in place
    (2, 208, 208, 128, 512, 128),  # upconv
    (1, 416, 416, 128, 128, 128),  # HRconv, one image
])
def test_k3_wgmma_route_is_exact(cuda, b, h, w, cin, cout, width):
    assert k3.route(cin) == "wgmma"
    g = np.random.default_rng(cin + h)
    full = _int8((b, h, w, width), g)
    full[0, :2, :2] = 127
    w8 = _int8((3, 3, cin, cout), g)
    w8[..., 0] = 127
    w8[..., 1] = -127
    x8 = full.to(cuda)[..., :cin]
    before = conv_i8.launches
    out = conv_i8(x8, w8.to(cuda))
    ref = conv_i8_reference(x8, w8.to(cuda))
    torch.cuda.synchronize()
    assert conv_i8.launches == before + 1
    print(f"K3 wgmma {(b, h, w, cin)} -> {cout}: max|sum| {ref.abs().max().item()}")
    assert torch.equal(out, ref)


# name: (cin, cout, concat level whose codes it writes or None, slope,
# res_scale, requantise, values beside the codes)
K3_VARIANTS = {
    "level1": (128, 128, 1, 0.2, None, True, False),
    "level2": (256, 128, 2, 0.2, None, True, False),
    "level3": (384, 128, 3, 0.2, None, True, False),
    "level4": (512, 128, 4, 0.2, None, True, False),
    "level5": (640, 128, None, None, 0.2, False, True),
    "conv_first": (4, 128, None, None, None, False, True),
    "trunk_conv": (128, 128, None, None, 1.0, False, True),
    "upconv": (128, 512, None, 0.01, None, False, True),
    "hrconv": (128, 128, None, 0.2, None, False, True),
    # values, and beside them the codes of the next block's (or upconv's)
    # input, into the first group of a fresh concat
    "level5+codes": (640, 128, 0, None, 0.2, True, True),
    "conv_first+codes": (4, 128, 0, None, None, True, True),
    "trunk_conv+codes": (128, 128, 0, None, 1.0, True, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(K3_VARIANTS))
def test_k3_fused_epilogue_equals_plain_version(cuda, name, dtype):
    # codes go into a concat slice filled with -128 (never a code): levels
    # 1-4 into the next slice of the buffer they read, the "+codes" variants
    # into the first group of another; values go into a NaN-filled output,
    # so an unwritten element shows; the plain version runs on the card too
    cin, cout, level, slope, res_scale, requant, values = K3_VARIANTS[name]
    b, h, w = 2, 37, 45
    g = np.random.default_rng(sum(map(ord, name)))
    in_concat = level is not None and level > 0
    buf = torch.full((b, h, w, 640 if in_concat else cin), -128, dtype=torch.int8)
    buf[..., :cin] = _int8((b, h, w, cin), g)
    buf = buf.to(cuda)
    x8 = buf[..., :cin]
    cat = buf if in_concat else torch.full((b, h, w, 640), -128, dtype=torch.int8, device=cuda)
    w8 = _int8((3, 3, cin, cout), g).to(cuda)
    c_o = torch.from_numpy((g.uniform(0.5, 2.0, cout) / (np.sqrt(9 * cin) * 73.0**2))
                           .astype(np.float32)).to(cuda)
    bias = torch.from_numpy((g.normal(size=cout) * 0.1).astype(np.float32)).to(cuda)
    residual = None
    if res_scale is not None:
        residual = torch.from_numpy(g.normal(size=(b, h, w, cout)).astype(np.float32)).to(cuda, dtype)
    epi = Epilogue(c_o, bias, dtype, slope=slope, res_scale=res_scale,
                   qscale=float(g.uniform(2.0, 4.0)) if requant else None, values=values)
    want = epi.apply(conv_i8_reference(x8, w8), residual)
    want = want if isinstance(want, tuple) else (want,)
    out = torch.full((b, h, w, cout), float("nan"), dtype=dtype, device=cuda) if values else None
    codes = cat[..., level * 128 : (level + 1) * 128] if requant else None
    rest = torch.cat([cat[..., : level * 128], cat[..., (level + 1) * 128 :]], -1).clone() \
        if requant else None
    before = conv_i8.launches
    got = conv_i8(x8, w8, epi, residual=residual, out=out, codes=codes)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    assert conv_i8.launches == before + 1
    assert [t.data_ptr() for t in got] == [t.data_ptr() for t in (out, codes) if t is not None]
    if requant:  # the channels around the written slice keep what they held
        assert torch.equal(torch.cat([cat[..., : level * 128], cat[..., (level + 1) * 128 :]], -1),
                           rest)
        assert bool((cat[..., (level + 1) * 128 :] == -128).all())
    for a, b_ in zip(got, want):
        diff = (a.float() - b_.float()).abs().max().item()
        print(f"K3 {k3.route(cin)} {name} {dtype} {a.dtype}: max|fused - plain| {diff}")
        assert a.dtype == b_.dtype and torch.equal(a, b_)


@pytest.mark.gpu
def test_k3_refuses_misaligned_or_ill_strided_output(cuda):
    g = np.random.default_rng(5)
    buf = _int8((1, 16, 16, 640), g).to(cuda)
    w8 = k3.pack_weights(_int8((3, 3, 128, 128), g), cuda)
    codes = Epilogue(torch.ones(128, device=cuda), torch.zeros(128, device=cuda), torch.bfloat16,
                     slope=0.2, qscale=3.0)
    values = Epilogue(torch.ones(128, device=cuda), torch.zeros(128, device=cuda), torch.float32,
                      res_scale=0.2)
    res = torch.zeros(1, 16, 16, 128, device=cuda)
    before = conv_i8.launches
    with pytest.raises(ValueError, match="cannot take this codes output"):  # odd base
        conv_i8(buf[..., :128], w8, codes, codes=buf[..., 129:257])
    with pytest.raises(ValueError, match="cannot take this codes output"):  # uneven pixels
        conv_i8(buf[..., :128], w8, codes, codes=buf[:, :, :, 128:256].transpose(1, 2))
    with pytest.raises(ValueError, match="overlaps"):
        conv_i8(buf[..., :128], w8, codes, codes=buf[..., 64:192])
    flat = torch.empty(16 * 16 * 128 + 1, device=cuda)
    with pytest.raises(ValueError, match="8-byte boundary"):  # f32 pair off its boundary
        conv_i8(buf[..., :128], w8, values, residual=res, out=flat[1:].view(1, 16, 16, 128))
    with pytest.raises(ValueError, match="residual"):
        conv_i8(buf[..., :128], w8, values, residual=flat[1:].view(1, 16, 16, 128))
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.empty(w8.kernel.numel() + 1, dtype=torch.int8, device=cuda)[1:]
        conv_i8(buf[..., :128], w8._replace(kernel=shifted.view(w8.kernel.shape)), codes,
                codes=buf[..., 128:256])
    assert conv_i8.launches == before
    conv_i8(buf[..., :128], w8, codes, codes=buf[..., 128:256])  # what they are refused for
    torch.cuda.synchronize()
    assert conv_i8.launches == before + 1


@pytest.mark.gpu
def test_k3_s8_level_is_warpgroup_mma(cuda):
    # the s8 level runs wgmma (IGMMA in the SASS), and only conv_first's
    # Tile128 keeps mma.sync (IMMA); the bf16 wgmma level keeps its 72 HGMMA
    ops = ("IGMMA", "HGMMA", "IMMA", "HMMA")
    k3_counts = _sass_counts("conv_i8", ops)
    print(k3_counts)
    wg = {fn: c for fn, c in k3_counts.items() if "conv3x3_wgmma_kernel" in fn}
    tile = {fn: c for fn, c in k3_counts.items() if "conv3x3_kernel" in fn}
    assert len(wg) == 1 and len(tile) == 1
    for c in wg.values():
        assert c["IGMMA"] > 0 and c["IMMA"] == c["HGMMA"] == c["HMMA"] == 0, c
    for c in tile.values():
        assert c["IMMA"] > 0 and c["IGMMA"] == 0, c
    bf16 = {fn: c for fn, c in _sass_counts("dense_block_s2d", ops).items()
            if "conv3x3_wgmma_kernel" in fn}
    print(bf16)
    assert [c["HGMMA"] for c in bf16.values()] == [72]


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


def _small_run_config(tmp_path):
    """The esr_gen_sr run config at 32^2 -> 64^2 (the smoke runs it at full size)."""
    root = PARAMS.parents[2]
    text = (root / "res/configs/runs/esr_gen_sr.toml").read_text()
    path = tmp_path / "run.toml"
    path.write_text(text.replace("res = 416", "res = 32").replace("res = 832", "res = 64"))
    return path


@pytest.mark.gpu
def test_cli_int8_scales_round_trip_on_the_card(cuda, tmp_path, monkeypatch):
    """`serve --int8 --int8_scales` twice on the card: the first run
    calibrates and writes the fingerprint-bound file, the second loads it
    and does not calibrate; both run every int8 convolution on K3 and give
    bitwise the same products."""
    import contextlib
    import io
    import json

    from xmm_superres_denoise_torch.cli import main
    from xmm_superres_denoise_torch.io.fits import read_image, write_image
    from xmm_superres_denoise_torch.ops import int8_forward
    from xmm_superres_denoise_torch.utils.fingerprint import params_fingerprint
    from xmm_superres_denoise_torch.utils.weights import flax_tree, load_params_npz

    g = np.random.default_rng(4)
    for i in range(3):
        hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0, "CRVAL1": 150.0,
               "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0}
        write_image(tmp_path / f"det{i}.fits", g.poisson(2.0, (28, 30)).astype(np.int32), hdr)
    calls = []
    real = int8_forward.calibrate_int8_scales
    monkeypatch.setattr(int8_forward, "calibrate_int8_scales",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    scales = tmp_path / "scales.json"
    products = []
    for i in range(2):
        out = io.StringIO()
        before = conv_i8.launches
        with contextlib.redirect_stdout(out):
            rc = main(["serve", str(tmp_path / "det*.fits"), "--checkpoint", str(PARAMS),
                       "--out", str(tmp_path / f"out{i}"), "--run_config",
                       str(_small_run_config(tmp_path)), "--batch", "2", "--int8",
                       "--int8_scales", str(scales), "--device", str(cuda)])
        assert rc == 0 and len(calls) == 1
        assert conv_i8.launches == before + 64 * 2  # two batches
        listing = json.loads(out.getvalue().strip().splitlines()[-1])
        products.append([read_image(p["prediction"])[0] for p in listing])
    saved = json.loads(scales.read_text())
    assert saved["fingerprint"] == params_fingerprint(
        {"params": flax_tree(load_params_npz(PARAMS, GeneratorRRDB_SR()))})
    for a, b in zip(*products):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_composite_loss_and_gradient_on_the_card_match_float64(cuda):
    """The esr_gen_sr loss (psnr 0.5 + ms_ssim 0.5, sqrt table) at (2, 208,
    208, 1) on the card with TF32 off against float64 on the CPU: value
    within 1e-5 relative, gradient within 1e-4 x max|grad|."""
    import tomllib

    from xmm_superres_denoise_torch.train.loss import create_loss, load_scaling_tables

    root = PARAMS.parents[2]
    with open(root / "res/configs/loss_functions.toml", "rb") as f:
        loss = create_loss(*load_scaling_tables(tomllib.load(f), "sqrt"))
    g = np.random.default_rng(5)
    target = np.repeat(np.repeat(g.uniform(0, 1, (2, 26, 26, 1)), 8, axis=1), 8, axis=2)
    preds = np.clip(target + 0.1 * g.normal(size=target.shape), 1e-3, 1.0)
    results = []
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        x = torch.from_numpy(preds).to(dev, dtype).requires_grad_()
        with true_f32():
            v = loss(x, torch.from_numpy(target).to(dev, dtype))
            v.backward()
        results.append((float(v), x.grad.double().cpu()))
    (v, grad), (v64, grad64) = results
    scale = grad64.abs().max().item()
    err = (grad - grad64).abs().max().item()
    print(f"value {v} vs {v64} ({abs(v - v64) / abs(v64):.3e} relative); gradient max|diff| "
          f"{err:.3e} = {err / scale:.3e} x max|grad|")
    assert abs(v - v64) <= 1e-5 * abs(v64)
    assert err <= 1e-4 * scale


# --------------------------------------------------------------------------- #
# gradients through K2, the inference-only refusals, evaluation on the card
# --------------------------------------------------------------------------- #

# l1 + psnr + ssim with the sqrt table: the run config's psnr + ms_ssim with
# SSIM for MS-SSIM, which needs 208 px
_GRAD_LOSS = dict(l1=0.3, poisson=0.0, psnr=0.4, ssim=0.3, ms_ssim=0.0)


def _grad_loss():
    import tomllib

    from xmm_superres_denoise_torch.config.schema import LossCfg
    from xmm_superres_denoise_torch.train.loss import create_loss

    with open(PARAMS.parents[2] / "res/configs/loss_functions.toml", "rb") as f:
        table = tomllib.load(f)["scaling"]["sqrt"]
    return create_loss(table, LossCfg(**_GRAD_LOSS))


def _grad_pair(shape=(1, 64, 64, 1), seed=3):
    """An input and a target in the model's domain: Poisson count rates of
    a 20 ks exposure at LR and of a 100 ks one at 2x, each a flat background
    with point sources, normalized as the run config normalizes them (sqrt
    stretch of the clamped rate)."""
    from xmm_superres_denoise_torch.ops.stretch import normalize

    g = np.random.default_rng(seed)

    def rates(hw, exposure_s, scale):
        lam = np.full(hw, g.uniform(0.5, 2.0) * exposure_s / 2e4)
        for _ in range(6):
            y, x = g.integers(0, hw[0] - 2 * scale), g.integers(0, hw[1] - 2 * scale)
            lam[y:y + 2 * scale, x:x + 2 * scale] += g.uniform(5, 40) * exposure_s / 2e4
        return torch.from_numpy((g.poisson(lam) / exposure_s).astype(np.float32))

    b, h, w, _ = shape
    x = torch.stack([rates((h, w), 2e4, 1) for _ in range(b)])[..., None]
    t = torch.stack([rates((2 * h, 2 * w), 1e5, 2) for _ in range(b)])[..., None]
    return normalize(x, 0.0022336, "sqrt"), normalize(t, 0.0005584, "sqrt")


def _model_grads(device, dtype, x, target):
    model = GeneratorRRDB_SR()
    model.load_state_dict(params_from_flax(PARAMS))
    model = model.to(device, dtype)
    loss = _grad_loss()
    with true_f32():
        before = dense_block.launches
        out = torch.clamp(model(x.to(device, dtype)), 0.0, 1.0)
        launches = dense_block.launches - before
        loss(out, target.to(device, dtype)).backward()
    return {n: p.grad for n, p in model.named_parameters()}, launches


@pytest.mark.gpu
def test_model_gradients_on_the_card_match_the_cpu_model(cuda):
    """Every one of the 130 parameters of the full-width esr_gen SR model gets
    a finite, non-zero gradient through K2 (60 level launches in the
    forward) within 1e-4 x max|g| of the CPU model's, in f32."""
    x, target = _grad_pair()
    card, launches = _model_grads(cuda, torch.float32, x, target)
    cpu, cpu_launches = _model_grads("cpu", torch.float32, x, target)
    # the noise floor: the CPU gradients again after a one-ulp change of the
    # input (a LeakyReLU pre-activation within f32 noise of 0 flips its slope)
    nudged, _ = _model_grads("cpu", torch.float32, torch.nextafter(x, x + 1), target)
    assert launches == 60 and cpu_launches == 0
    assert len(card) == 130
    errs, floor = {}, 0.0
    for n, g in card.items():
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, n
        scale = float(cpu[n].abs().max())
        errs[n] = float((g.cpu() - cpu[n]).abs().max()) / scale
        floor = max(floor, float((nudged[n] - cpu[n]).abs().max()) / scale)
    worst = max(errs, key=errs.get)
    print(f"130 gradients, largest max|g_card - g_cpu| / max|g_cpu| {errs[worst]:.3e} ({worst}); "
          f"the CPU's own after a one-ulp input change: {floor:.3e}")
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.mark.gpu
def test_bf16_model_gradients_on_the_card_are_finite(cuda):
    x, target = _grad_pair()
    grads, launches = _model_grads(cuda, torch.bfloat16, x, target)
    assert launches == 60 and len(grads) == 130
    for n, g in grads.items():
        assert g is not None and g.dtype == torch.bfloat16 and torch.isfinite(g).all(), n


@pytest.mark.gpu
def test_dense_block_routes_by_grad_mode_on_the_card(cuda):
    x, ws = _block_inputs((1, 24, 40, 32), torch.float32, cuda, seed=4)
    for grad_mode, wants in ((torch.no_grad, False), (torch.enable_grad, False)):
        before = dense_block.launches
        with grad_mode():
            y = dense_block(x, *ws)
        assert dense_block.launches - before == 5 and (y.grad_fn is not None) is wants
    xg = x.clone().requires_grad_()
    before = dense_block.launches
    y = dense_block(xg, *ws)
    assert dense_block.launches - before == 5
    assert type(y.grad_fn).__name__ == "_DenseBlockFnBackward"
    with true_f32():
        plain = dense_block_reference(x, *ws)
    assert float((y.detach() - plain).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_inference_only_ops_refuse_a_gradient_on_the_card(cuda):
    from xmm_superres_denoise_torch.ops.dense_block import make_fast_rrdb_forward, rrdb_fused

    x, ws = _block_inputs((1, 16, 104, 128), torch.float32, cuda, seed=5)
    with pytest.raises(RuntimeError, match="inference only"):
        dense_block_s2d(x.clone().requires_grad_(), ws[0::2], ws[1::2])
    with pytest.raises(RuntimeError, match="inference only"):
        dense_block_s2d(x, pack_weights([w.requires_grad_() for w in ws[0::2]], ws[1::2],
                                        torch.float32))
    x8 = torch.zeros((1, 8, 8, 128), dtype=torch.int8, device=cuda)
    w8 = torch.zeros((3, 3, 128, 128), dtype=torch.int8, device=cuda)
    ep = Epilogue(torch.ones(128, device=cuda), torch.zeros(128, device=cuda), torch.float32,
                  res_scale=0.2)
    residual = torch.zeros((1, 8, 8, 128), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        conv_i8(x8, w8, ep, residual=residual)
    pairs = [[(torch.zeros(3, 3, 32 * k, 32, device=cuda), torch.zeros(32, device=cuda))
              for k in range(1, 6)]] * 3
    with pytest.raises(RuntimeError, match="inference only"):
        rrdb_fused(torch.zeros((1, 8, 8, 32), device=cuda, requires_grad=True), pairs)
    model = GeneratorRRDB_SR()
    fast = make_fast_rrdb_forward(model, params_from_flax(PARAMS), torch.float32, cuda)
    with pytest.raises(RuntimeError, match="inference only"):
        fast(torch.zeros((1, 16, 16, 1), device=cuda, requires_grad=True))


@pytest.mark.gpu
def test_collections_on_the_card_match_cpu_float64(cuda):
    """Core and extended collections (with `in:` twins' keys) on the card in
    f32 against the same on the CPU in float64: within 1e-4 relative, FSIM
    5e-4."""
    from xmm_superres_denoise_torch.metrics import (
        get_ext_metrics,
        get_in_metrics,
        get_metrics,
    )
    from xmm_superres_denoise_torch.ops.stretch import Normalizer

    g = np.random.default_rng(6)
    coarse = g.uniform(0.05, 1, (3, 26, 26, 1))
    t = np.clip(np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
                + 0.03 * g.normal(size=(3, 208, 208, 1)), 0, 1)
    p = np.clip(t + 0.05 * g.normal(size=t.shape), 0, 1)
    w = np.array([1.0, 1.0, 0.0])
    ds = Normalizer(0.0022336, 0.0005584, "sqrt")
    scalers = [Normalizer(0.0022336, 0.0005584, m) for m in ("linear", "sqrt")]
    worst = 0.0
    for make in (get_metrics, get_in_metrics, get_ext_metrics):
        coll = make(ds, scalers, "test")
        out = []
        for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
            st = coll.init(dev, dtype)
            args = [torch.from_numpy(a).to(dev, dtype) for a in (p, t, w)]
            with true_f32():
                st = coll.update(st, *args)
            out.append({k: float(v) for k, v in coll.compute(st).items()})
        for k, v64 in out[1].items():
            rel = abs(out[0][k] - v64) / max(abs(v64), 1e-12)
            worst = max(worst, rel)
            assert rel <= (5e-4 if k.endswith("fsim") else 1e-4), (k, out[0][k], v64)
    print(f"collections on the card vs float64: largest relative difference {worst:.3e}")


@pytest.mark.gpu
def test_loader_on_the_card_matches_the_cpu_loader(cuda, tmp_path):
    from xmm_superres_denoise_torch.config.schema import DatasetCfg, HrDatasetCfg, LrDatasetCfg
    from xmm_superres_denoise_torch.data.datamodule import XmmDataModule
    from xmm_superres_denoise_torch.data.synthetic import write_sim_tree

    write_sim_tree(tmp_path, name="simds", n_base=20, lr_hw=(30, 28), seed=2)
    cfg = DatasetCfg(lr=LrDatasetCfg(exps=[20], clamp_max=0.0022336, res=32),
                     hr=HrDatasetCfg(exp=100, clamp_max=0.0005584, res=64),
                     batch_size=3, directory=tmp_path, name="simds")
    card = XmmDataModule(cfg, splits_root=tmp_path / "s", seed=1)
    cpu = XmmDataModule(cfg, splits_root=tmp_path / "s", seed=1, device="cpu")
    assert card.device == torch.device("cuda:0")
    for a, b in zip(card.loader("train"), cpu.loader("train")):
        for k in ("lr", "hr", "weight"):
            assert a[k].is_cuda
            np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(), rtol=0, atol=1e-6)
