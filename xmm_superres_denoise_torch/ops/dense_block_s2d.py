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
  or raises; there is no fallback. bf16 levels are the tensor-core level
  of `csrc/dense_block_s2d.cu` (`dense_level_bf16.cuh`, K2's bf16 level
  too: at C = 128 `wgmma` fed by TMA, `csrc/conv3x3_wgmma.cuh`, which
  needs weights on a 16-byte boundary); f32 levels are K2's CUDA-core level
  (`csrc/dense_block.cu` -> `csrc/conv3x3_f32.cuh`, FFMA only, also 16-byte
  weight copies), since TF32 would leave the f32 parity class. For a CPU
  tensor it runs the plain version.
* `pack_weights` (`PackedBlock`, both from `ops/dense_block.py`, which K2
  shares) casts and lays the weights out once, for a forward that calls
  the block many times: bf16 as (9, C, k*C), the K-major order of the
  tensor cores' B operand; f32 as HWIO for the CUDA-core kernel. Raw
  tuples are packed on every call.
* `dense_block_s2d_reference` is the plain version: the gather form, f32
  convolutions, each level rounded to `x.dtype` as the kernel stores it.
* `dense_block_s2d.launches` counts kernel launches (five per call).
* K1 serves inference only: with grad enabled and an input that requires
  grad it raises `RuntimeError` (`refuse_grad`) on every device, rather than
  return a tensor without a `grad_fn`.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from . import cuda_build
from .dense_block import (  # noqa: F401  (PackedBlock, pack_weights: re-exported)
    PackedBlock,
    check_packed,
    dense_block_reference,
    refuse_grad,
    launch_levels,
    level_kernel,
    pack_weights,
)

Tensor = torch.Tensor

_CHANNELS = 128  # output channels per block of the bf16 kernel
_I, _P = cuda_build.I, cuda_build.P
_SIGNATURES = {
    "dense_block_s2d_level": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P],
}


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
    check_packed(x, packed, "dense_block_s2d", _CHANNELS)


def dense_block_s2d(
    x: Tensor,
    weights: Union[Sequence[Tensor], PackedBlock],
    biases: Sequence[Tensor] = (),
    h_strip: int = 16,
    w_tile: int = 104,
) -> Tensor:
    """One ResidualDenseBlock5C forward in the S2D domain (SAME padding)."""
    _check_tiling(x, h_strip, w_tile)
    if isinstance(weights, PackedBlock):
        refuse_grad("dense_block_s2d", x, *weights.hwio, *weights.biases)
        packed = weights
    else:
        refuse_grad("dense_block_s2d", x, *weights, *biases)
        packed = pack_weights(weights, biases, x.dtype)
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
