"""P: the s8 x s8 -> s32 matrix product on a hand-written Hopper kernel.

Replaces the probe `kernel` of `scripts/device_probe_pallas_int8.py` of
the JAX repository: an exact int8 matrix product with int32 sums at
(2048, 128) x (128, 128). int8 serving runs it once when it builds its
forward on a card (`check_int8_exact`), as the probe was the go/no-go check
that the device's int8 sums are exact. It proves the instruction that
every convolution of int8 serving runs on (K3, `ops/conv_i8.py`, both
routes): `wgmma.mma_async.m64n128k32.s32.s8.s8` with A from registers and
B through a shared-memory descriptor with the 128-byte swizzle
(`csrc/wgmma.cuh`).

* `int8_gemm(a, b)`: a (M, K), b (K, N) int8, row-major; returns (M, N)
  int32. K % 32 == 0, N % 8 == 0, any M; a block computes 64 x 128 of the
  output and masks the ragged edges. For a CUDA tensor it launches the
  kernel of `csrc/int8_gemm.cu` or raises; for a CPU tensor it runs the
  plain version.
* `int8_gemm_reference`: int64 `torch.matmul` (float64 on a card), cast
  to int32.
* `int8_gemm.launches` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

Tensor = torch.Tensor

PROBE_SHAPE = (2048, 128, 128)  # M, K, N of the TPU probe
_I, _P = cuda_build.I, cuda_build.P
_SIGNATURES = {"int8_gemm": [_I, _P, _P, _P, _I, _I, _I, _P]}
_BM = 64  # output rows per block
_MAX_GRID_Y = 65535


def int8_gemm_reference(a: Tensor, b: Tensor) -> Tensor:
    """Plain version: an int64 matrix product on the CPU (float64 on a
    card, which has no int64 product; exact while K * 127^2 < 2^53), cast
    to int32."""
    if a.device.type == "cpu":
        return torch.matmul(a.long(), b.long()).to(torch.int32)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_gemm(a: Tensor, b: Tensor) -> Tensor:
    """Exact (M, K) x (K, N) int8 product with int32 sums."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm takes (M, K) x (K, N), got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8, got {a.dtype} and {b.dtype}")
    device = a.device
    if b.device != device:
        raise ValueError(f"int8_gemm operands on {device} and {b.device}")
    if device.type == "cpu":
        return int8_gemm_reference(a, b)
    if device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, got {device}")
    m, k = a.shape
    n = b.shape[1]
    if k % 32 or n % 8 or m == 0 or (m + _BM - 1) // _BM > _MAX_GRID_Y:
        raise ValueError(f"int8_gemm kernel needs K % 32 == 0 and N % 8 == 0, got "
                         f"M={m}, K={k}, N={n}")
    a_ptr, b_ptr = a.data_ptr(), b.data_ptr()
    if not (a.is_contiguous() and b.is_contiguous()) or a_ptr % 16 or b_ptr % 4:
        raise ValueError("int8_gemm kernel needs contiguous, aligned operands")
    lib = cuda_build.library("int8_gemm", _SIGNATURES)
    out = torch.empty((m, n), dtype=torch.int32, device=device)
    err = lib.int8_gemm(cuda_build.device_index(a), a_ptr, b_ptr, out.data_ptr(), m, n, k,
                        cuda_build.stream_of(a))
    cuda_build.check(lib, "int8_gemm", err, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def probe_operands(device, seed: int = 0):
    """The probe's operands: int8 in [-100, 100) at `PROBE_SHAPE`, from a seed."""
    g = np.random.default_rng(seed)
    m, k, n = PROBE_SHAPE
    a = torch.from_numpy(g.integers(-100, 100, (m, k)).astype(np.int8)).to(device)
    b = torch.from_numpy(g.integers(-100, 100, (k, n)).astype(np.int8)).to(device)
    return a, b


def check_int8_exact(device) -> None:
    """Run P once on `device` at the probe's shape and raise unless its
    int32 sums equal the plain version's exact ones."""
    a, b = probe_operands(device)
    got = int8_gemm(a, b)
    want = int8_gemm_reference(a, b)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"int8 tensor-core sums are not exact on {device}: {bad} differ")
