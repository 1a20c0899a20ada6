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
* `dense_block_s2d` serves inference only: with grad enabled and an input
  that requires grad it raises `RuntimeError` (`refuse_grad`) on every
  device, rather than return a tensor without a `grad_fn`.
* `dense_block_s2d_train(x4, w1, b1, ..., w5, b5)` is K1's gradient route,
  the forward of the S2D training route (`models/rrdb.py`, `s2d=True`):
  it takes the block's ten parameters in the ORIGINAL domain (HWIO, C/4
  channels) and runs as one autograd node, `_DenseBlockS2DFn` (K1 forward,
  backward recomputed in the original domain).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from . import cuda_build
from .dense_block import (  # noqa: F401  (PackedBlock, pack_weights: re-exported)
    PackedBlock,
    block_grads,
    check_packed,
    dense_block_reference,
    refuse_grad,
    launch_levels,
    level_kernel,
    pack_weights,
)
from .precision import true_f32

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
    return _run(x, packed)


def _run(x: Tensor, packed: PackedBlock) -> Tensor:
    """K1 on a CUDA input (or raise), the plain version on a CPU one."""
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


def _s2d_pack(x4: Tensor, raw: Sequence[Tensor]) -> PackedBlock:
    """The block's ten original-domain parameters moved into the S2D domain
    (`s2d_conv_weights_torch`, an einsum against a 0/1 tensor: each entry is
    one weight times 1, exact in any dtype once TF32 is off) and packed for
    K1 in `x4`'s dtype."""
    from .space_to_depth import s2d_conv_weights_torch

    with true_f32():
        pairs = [s2d_conv_weights_torch(raw[i], raw[i + 1]) for i in range(0, 10, 2)]
    return pack_weights([w for w, _ in pairs], [b for _, b in pairs], x4.dtype)


class _DenseBlockS2DFn(torch.autograd.Function):
    """K1 as one autograd node of the ORIGINAL block's parameters.

    `apply(x4, w1, b1, ..., w5, b5)`: `x4` is the S2D-domain input (B, H/2,
    W/2, 4C), the ten tensors the block's original-domain parameters (HWIO,
    C channels, of `x4`'s dtype). The forward transforms and packs them
    (`_s2d_pack`) and launches K1 (the plain version on the CPU); it keeps
    only `x4` and the parameters.

    The backward works in the original domain: the S2D block is the
    original block conjugated by `s2d` (`ops/space_to_depth.py`), so with
    x = d2s(x4) and g = d2s(grad_out) the gradients are those of the
    original block at x against g (`block_grads`, `_DenseBlockFn`'s
    backward: the plain version under `true_f32` in f32, bf16 convolutions
    in bf16), and the input's is moved back by `s2d`. The parameters'
    gradients come back directly. The JAX package differentiates its S2D
    apply through the weight transform with convolutions at 4C; the
    gradients are the same function's, and on the card the original domain
    is the faster route in both dtypes (PERF.md, PR 12)."""

    @staticmethod
    def forward(ctx, x4: Tensor, *raw: Tensor) -> Tensor:
        ctx.save_for_backward(x4, *raw)
        return _run(x4, _s2d_pack(x4, raw))

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        from .space_to_depth import d2s, s2d

        x4, *raw = ctx.saved_tensors
        grads = block_grads(d2s(x4).contiguous(), raw, ctx.needs_input_grad,
                            d2s(grad_out).contiguous())
        if grads[0] is not None:
            grads[0] = s2d(grads[0]).contiguous()
        return tuple(grads)


def dense_block_s2d_train(x4: Tensor, *raw: Tensor) -> Tensor:
    """One dense block in the S2D domain on K1, differentiable with respect
    to `x4` and the ten original-domain parameters (`_DenseBlockS2DFn`).
    `x4` is (B, H, W, 4C) NHWC; `raw` is (w1, b1, ..., w5, b5), HWIO with
    C channels, of `x4`'s dtype. A CUDA input launches K1 (or raises), a
    CPU input runs the plain version."""
    if len(raw) != 10:
        raise TypeError("dense_block_s2d_train takes ten original-domain parameters")
    if x4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_block_s2d_train runs on cuda or cpu, got {x4.device}")
    c = raw[-1].shape[0]
    if x4.dim() != 4 or x4.shape[-1] != 4 * c:
        raise ValueError(f"dense_block_s2d_train: x4 {tuple(x4.shape)} is not the S2D form of "
                         f"a {c}-channel block input")
    return _DenseBlockS2DFn.apply(x4.contiguous(), *raw)
