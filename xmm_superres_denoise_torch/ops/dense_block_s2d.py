"""K1: the residual dense block in the space-to-depth domain, on a
hand-written Hopper kernel.

Replaces the Pallas TPU kernel `ops/pallas_dense_block.py::
dense_block_s2d_pallas` of the JAX package: one `ResidualDenseBlock5C` at
C = 128 channels (the 2x2 space-to-depth of the 32-filter block), NHWC
input, HWIO weights cast to the input's dtype, f32 accumulation, output
`0.2 * x5 + x`.

* `dense_block_s2d(x, weights, biases, h_strip=16, w_tile=104)` is the
  entry point, with K1's signature: a 5-tuple of weights w_k (3, 3, k*C, C)
  and a 5-tuple of biases b_k (C,), or a `PackedBlock` from
  `pack_weights` (then `biases` is ignored). It raises `ValueError` on the
  shapes K1 rejects (H % h_strip, W % w_tile); the tiling arguments do not
  drive the CUDA tiling. For a CUDA tensor it launches five level kernels
  (one per level, over one NHWC concat buffer, `dense_block.launch_levels`)
  or raises; there is no fallback. bf16 levels are the tensor-core kernel
  of `csrc/dense_block_s2d.cu`; f32 levels are K2's CUDA-core kernel
  (`csrc/dense_block.cu`), since TF32 would leave the f32 parity class. For
  a CPU tensor it runs the plain version.
* `pack_weights` casts and lays the weights out once, for a forward that
  calls the block many times: bf16 as (9, C, k*C), the K-major order of the
  tensor cores' B operand; f32 as HWIO for the CUDA-core kernel. Raw
  tuples are packed on every call.
* `dense_block_s2d_reference` is the plain version: the gather form, f32
  convolutions, each level rounded to `x.dtype` as the kernel stores it.
* `dense_block_s2d.launches` counts kernel launches (five per call).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import torch

from . import cuda_build
from .dense_block import dense_block_reference, launch_levels, level_kernel

Tensor = torch.Tensor

_DTYPES = (torch.float32, torch.bfloat16)
_CHANNELS = 128  # output channels per block of the bf16 kernel
_MAX_GRID_Z = 65535
_I, _P = cuda_build.I, cuda_build.P
_SIGNATURES = {
    "dense_block_s2d_level": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P],
}


class PackedBlock(NamedTuple):
    """The weights of one block, cast and laid out once."""

    hwio: Tuple[Tensor, ...]  # w_k (3, 3, k*C, C), for the plain version
    biases: Tuple[Tensor, ...]  # b_k (C,)
    kernel: Tuple[Tensor, ...]  # what the kernel reads: bf16 (9, C, k*C), f32 HWIO


def pack_weights(
    weights: Sequence[Tensor], biases: Sequence[Tensor], dtype: torch.dtype
) -> PackedBlock:
    """Cast the block's weights and biases to `dtype` (as K1 casts them to
    `x.dtype`) and lay them out for the kernel, on the weights' device."""
    hwio = tuple(w.to(dtype).contiguous() for w in weights)
    bs = tuple(b.to(dtype).contiguous() for b in biases)
    if dtype == torch.bfloat16:
        kernel = tuple(
            w.reshape(9, w.shape[2], w.shape[3]).transpose(1, 2).contiguous() for w in hwio
        )
    else:
        kernel = hwio
    return PackedBlock(hwio, bs, kernel)


def dense_block_s2d_reference(
    x: Tensor, weights: Sequence[Tensor], biases: Sequence[Tensor]
) -> Tensor:
    """Plain version: weights and biases cast to `x.dtype`, then the gather
    form with f32 convolutions, each level rounded to `x.dtype`."""
    flat = []
    for w, b in zip(weights, biases):
        flat += [w.to(x.dtype), b.to(x.dtype)]
    return dense_block_reference(x, *flat)


def _check_tiling(x: Tensor, h_strip: int, w_tile: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"dense_block_s2d expects NHWC (B, H, W, C), got {tuple(x.shape)}")
    _, h, w, _ = x.shape
    if h % h_strip or w % w_tile:
        raise ValueError(
            f"dense_block_s2d needs H % h_strip == 0 and W % w_tile == 0, got "
            f"H={h}, W={w}, h_strip={h_strip}, w_tile={w_tile}"
        )


def _check_args(x: Tensor, packed: PackedBlock) -> None:
    """Raise on anything the kernel does not take."""
    b, h, w, c = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"dense_block_s2d kernel takes float32 or bfloat16, got {x.dtype}")
    if c % _CHANNELS:
        raise ValueError(f"dense_block_s2d kernel needs C % 128 == 0, got C={c}")
    if b * (c // 32) > _MAX_GRID_Z or b * h * w == 0:
        raise ValueError(f"dense_block_s2d kernel cannot take shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dense_block_s2d kernel needs a contiguous NHWC input")
    if len(packed.kernel) != 5 or len(packed.biases) != 5:
        raise ValueError("dense_block_s2d takes five weights and five biases")
    for k in range(1, 6):
        wk, bk = packed.kernel[k - 1], packed.biases[k - 1]
        want = (9, c, k * c) if x.dtype == torch.bfloat16 else (3, 3, k * c, c)
        if tuple(wk.shape) != want or tuple(bk.shape) != (c,):
            raise ValueError(
                f"level {k}: expected packed w {want} and b ({c},), got "
                f"{tuple(wk.shape)} and {tuple(bk.shape)}"
            )
        for t in (wk, bk):
            if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
                raise ValueError(
                    f"level {k}: weights must be contiguous {x.dtype} on {x.device}"
                )


def dense_block_s2d(
    x: Tensor,
    weights: Union[Sequence[Tensor], PackedBlock],
    biases: Sequence[Tensor] = (),
    h_strip: int = 16,
    w_tile: int = 104,
) -> Tensor:
    """One ResidualDenseBlock5C forward in the S2D domain (SAME padding)."""
    _check_tiling(x, h_strip, w_tile)
    packed = weights if isinstance(weights, PackedBlock) else pack_weights(weights, biases, x.dtype)
    if x.device.type == "cpu":
        return dense_block_s2d_reference(x, packed.hwio, packed.biases)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block_s2d runs on cuda or cpu, got {x.device}")
    _check_args(x, packed)
    if x.dtype == torch.bfloat16:
        lib, lib_name = cuda_build.library("dense_block_s2d", _SIGNATURES), "dense_block_s2d"
        level = lib.dense_block_s2d_level
    else:  # f32: K2's CUDA-core level kernel, HWIO weights
        lib, level = level_kernel(torch.float32)
        lib_name = "dense_block"
    return launch_levels(x, packed.kernel, packed.biases, lib, lib_name, level, dense_block_s2d)


dense_block_s2d.launches = 0
