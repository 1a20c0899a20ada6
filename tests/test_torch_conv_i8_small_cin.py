"""K3's (tap, channel) route, the one conv_first runs on a card
(`xmm_superres_denoise_torch/ops/conv_i8.py: pack_weights`, `route`,
`taps_geometry`; the kernel is `csrc/conv3x3_tapk.cuh`), on the CPU.

The kernel multiplies an implicit im2col of the input by the packed
weights, K ordered (tap, channel) over Cin rounded up to 4 and padded to
32 bytes, in chunks of 64 channels above that. The same product is
written out here as an explicit int64 im2col GEMM on the packed weights
and held, exactly, to the plain version (`conv_i8_reference`) and to the
JAX package's `_conv_i8` (`xmm_superres_denoise_tpu/ops/int8_forward.py`,
XLA's int8 convolution with int32 sums) on the same numpy-seeded inputs,
at Cin 1, 3, 4, 32, 64 and 96 (two chunks) and 160 (three). The int8
forward's conv_first, built on the CPU from the trained weights, packs for
this route and keeps its products: the plain version's codes and values, and
int32 sums equal to JAX's and to the GEMM on its packed weights.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops import int8_forward as ti8
from xmm_superres_denoise_torch.ops.conv_i8 import (
    conv_i8_reference,
    pack_weights,
    route,
    taps_geometry,
)
from xmm_superres_denoise_tpu.ops import int8_forward as ji8

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"


def _taps_gemm(x8: torch.Tensor, kernel: torch.Tensor, cin: int) -> torch.Tensor:
    """The route's product as an explicit im2col GEMM in int64: column
    c * kc + tap * ch + i holds channel c * ch + i of the pixel at tap
    (tap // 3 - 1, tap % 3 - 1), zero outside the image and past Cin."""
    ch, chunks, kc = taps_geometry(cin)
    b, h, w, _ = x8.shape
    xp = torch.zeros((b, h + 2, w + 2, chunks * ch), dtype=torch.int64)
    xp[:, 1:-1, 1:-1, :cin] = x8.long()
    cols = torch.zeros((b, h, w, chunks, kc), dtype=torch.int64)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        window = xp[:, dy : dy + h, dx : dx + w].reshape(b, h, w, chunks, ch)
        cols[..., tap * ch : (tap + 1) * ch] = window
    y = cols.reshape(b * h * w, chunks * kc) @ kernel.long().t()
    return y.reshape(b, h, w, -1)


@pytest.mark.parametrize("cin", [1, 3, 4, 32, 64, 96, 160])
def test_taps_packing_is_an_exact_im2col_gemm(cin):
    g = np.random.default_rng(cin)
    x = g.integers(-127, 128, (2, 5, 7, cin)).astype(np.int8)
    w = g.integers(-127, 128, (3, 3, cin, 128)).astype(np.int8)
    x[0, :2, :2], w[..., 0] = 127, 127  # the largest sums
    packed = pack_weights(w)
    ch, chunks, kc = taps_geometry(cin)
    assert route(cin) == "wgmma_taps"
    assert tuple(packed.kernel.shape) == (128, chunks * kc) and kc % 32 == 0
    assert chunks == (1 if cin <= 64 else -(-cin // 64))
    got = _taps_gemm(torch.from_numpy(x), packed.kernel, cin)
    want = conv_i8_reference(torch.from_numpy(x), torch.from_numpy(w))
    jax_sums = np.asarray(ji8._conv_i8(jnp.asarray(x), jnp.asarray(w)))
    print(f"Cin {cin}: ch {ch}, {chunks} chunk(s) of {kc} bytes of K, max|sum| "
          f"{int(want.abs().max())}")
    assert torch.equal(got, want.long())
    assert np.array_equal(want.numpy(), jax_sums)


def test_taps_packing_puts_only_zeros_in_the_padding():
    # Cin 4: K is 9 taps x 4 channels = 36 bytes of 64; Cin 3 adds a zero
    # channel per tap; every padded byte must be zero, or the kernel would
    # add it to the sums
    g = np.random.default_rng(1)
    for cin in (3, 4):
        w = g.integers(1, 128, (3, 3, cin, 128)).astype(np.int8)  # no zero weight
        k = pack_weights(w).kernel.view(128, 9 * 4 + 28)
        assert bool((k[:, 36:] == 0).all())
        taps = k[:, :36].view(128, 9, 4)
        assert bool((taps[..., cin:] == 0).all()) and bool((taps[..., :cin] != 0).all())
        assert torch.equal(taps[..., :cin].permute(1, 2, 0).reshape(3, 3, cin, 128),
                           torch.from_numpy(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_forward_conv_first_products_are_unchanged(dtype, monkeypatch):
    # the forward's first K3 call is conv_first: record it, then hold its
    # products to the plain composition, its sums to JAX's and to the GEMM
    # on the weights it packed for the card
    model = GeneratorRRDB_SR()
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 16, 16, 1)).astype(np.float32))
    scales = ti8.calibrate_int8_scales(model, PARAMS, x, "cpu")
    calls = []
    real = ti8.conv_i8

    def record(x8, packed, epi=None, **kw):
        out = real(x8, packed, epi, **kw)
        calls.append((x8.clone(), packed, epi, kw, out))
        return out

    monkeypatch.setattr(ti8, "conv_i8", record)
    fwd = ti8.make_int8_s2d_forward(model, PARAMS, dtype=dtype, scales=scales, device="cpu")
    fwd(x)
    x8, packed, epi, kw, (fea, codes) = calls[0]
    assert x8.shape == (1, 8, 8, 4) and route(x8.shape[3]) == "wgmma_taps"
    assert tuple(packed.kernel.shape) == (128, 64)
    sums = conv_i8_reference(x8, packed.hwio)
    assert torch.equal(_taps_gemm(x8, packed.kernel, 4), sums.long())
    jax_sums = np.asarray(ji8._conv_i8(jnp.asarray(x8.numpy()), jnp.asarray(packed.hwio.numpy())))
    assert np.array_equal(sums.numpy(), jax_sums)
    want_fea, want_codes = epi.apply(sums)
    assert fea.dtype == dtype and torch.equal(fea, want_fea)
    assert torch.equal(codes, want_codes) and torch.equal(kw["codes"], want_codes)
    print(f"conv_first {dtype}: {x8.shape} -> {tuple(fea.shape)}, max|sum| "
          f"{int(sums.abs().max())}, codes in [{int(codes.min())}, {int(codes.max())}]")
