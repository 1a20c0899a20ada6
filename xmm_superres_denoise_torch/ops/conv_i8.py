"""K3: the s8 x s8 -> s32 SAME 3x3 convolution on a hand-written Hopper
kernel.

Replaces `ops/int8_forward.py::_conv_i8` of the JAX package, the XLA int8
convolution with int32 accumulation that carries every convolution of int8
serving; PyTorch has no CUDA int8 convolution.

* `conv_i8(x8, w8)`: x8 (B, H, W, Cin) int8 NHWC, w8 (3, 3, Cin, Cout) int8
  HWIO or a `PackedI8` from `pack_weights`; returns (B, H, W, Cout) int32.
  For a CUDA tensor it launches the kernel of `csrc/conv_i8.cu` or raises;
  there is no fallback. For a CPU tensor it runs the plain version. x8 may
  be a channel prefix of a wider NHWC buffer (`buf[..., :cin]`): the kernel
  reads it in place.
* `pack_weights` lays the weights out once as (9, Cout, Cin32), Cin zero-
  padded to a multiple of 32 (the s8 mma's K depth); the wrapper pads the
  activations' channels to match, which adds zeros to every sum. Raw HWIO
  weights are packed on every call.
* `conv_i8_reference`: the plain version, `F.conv2d` in float64, exact
  here (|sum| <= 9 * 640 * 127^2 < 2^53), cast to int32.
* `conv_i8.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

Tensor = torch.Tensor

_K_DEPTH = 32  # bytes of K per s8 mma k-step
_OUT_CHANNELS = 128  # output channels per block
_MAX_GRID_Z = 65535
_I, _P = cuda_build.I, cuda_build.P
_SIGNATURES = {"conv_i8": [_I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P]}


class PackedI8(NamedTuple):
    """int8 HWIO weights and their kernel layout, made once."""

    hwio: Tensor  # (3, 3, Cin, Cout) int8, for the plain version
    kernel: Tensor  # (9, Cout, Cin rounded up to 32) int8


def pack_weights(w8: Union[Tensor, np.ndarray], device="cpu") -> PackedI8:
    """HWIO int8 weights -> `PackedI8` on `device`."""
    hwio = torch.as_tensor(np.asarray(w8) if isinstance(w8, np.ndarray) else w8)
    if hwio.dtype != torch.int8 or hwio.dim() != 4 or tuple(hwio.shape[:2]) != (3, 3):
        raise ValueError(f"conv_i8 weights must be (3, 3, Cin, Cout) int8, got "
                         f"{tuple(hwio.shape)} {hwio.dtype}")
    hwio = hwio.to(device).contiguous()
    cin, cout = hwio.shape[2], hwio.shape[3]
    kernel = hwio.reshape(9, cin, cout).transpose(1, 2)
    pad = -cin % _K_DEPTH
    if pad:
        kernel = F.pad(kernel, (0, pad))
    return PackedI8(hwio, kernel.contiguous())


def conv_i8_reference(x8: Tensor, w8: Tensor) -> Tensor:
    """Plain version: the exact int32 sums through a float64 convolution."""
    y = F.conv2d(
        x8.permute(0, 3, 1, 2).double(), w8.permute(3, 2, 0, 1).double(), padding=1
    )
    return y.round().to(torch.int32).permute(0, 2, 3, 1)


def _pixel_stride(x8: Tensor) -> int:
    """The pixel stride of an NHWC tensor whose pixels are evenly spaced
    (contiguous, or a channel prefix of a contiguous buffer), else -1."""
    b, h, w, c = x8.shape
    s = x8.stride()
    if s[3] != 1 or s[2] < c or s[1] != w * s[2] or (b > 1 and s[0] != h * w * s[2]):
        return -1
    return s[2]


def conv_i8(x8: Tensor, w8: Union[Tensor, PackedI8]) -> Tensor:
    """SAME 3x3 s8 convolution, NHWC in, int32 NHWC out."""
    packed = w8 if isinstance(w8, PackedI8) else pack_weights(w8, x8.device)
    if x8.dim() != 4 or x8.dtype != torch.int8:
        raise TypeError(f"conv_i8 takes NHWC int8, got {tuple(x8.shape)} {x8.dtype}")
    cin, cout = packed.hwio.shape[2], packed.hwio.shape[3]
    if x8.shape[3] != cin:
        raise ValueError(f"conv_i8: input has {x8.shape[3]} channels, weights {cin}")
    if x8.device.type == "cpu":
        return conv_i8_reference(x8, packed.hwio)
    if x8.device.type != "cuda":
        raise ValueError(f"conv_i8 runs on cuda or cpu, got {x8.device}")
    b, h, w, _ = x8.shape
    cin_k = packed.kernel.shape[2]
    if cin_k != cin:  # pad the activations' channels as the weights were
        x8 = F.pad(x8, (0, cin_k - cin))
    stride = _pixel_stride(x8)
    if stride < 0 or stride % 16 or x8.data_ptr() % 16:
        raise ValueError("conv_i8 kernel needs evenly spaced, 16-byte aligned NHWC pixels")
    if cout % _OUT_CHANNELS or b * (cout // _OUT_CHANNELS) > _MAX_GRID_Z or b * h * w == 0:
        raise ValueError(f"conv_i8 kernel cannot take {tuple(x8.shape)} -> {cout} channels")
    if packed.kernel.device != x8.device or not packed.kernel.is_contiguous():
        raise ValueError(f"conv_i8 weights must be contiguous on {x8.device}")
    lib = cuda_build.library("conv_i8", _SIGNATURES)
    out = torch.empty((b, h, w, cout), dtype=torch.int32, device=x8.device)
    err = lib.conv_i8(
        cuda_build.device_index(x8), x8.data_ptr(), b, h, w, stride, cin_k,
        packed.kernel.data_ptr(), cout, out.data_ptr(), cuda_build.stream_of(x8),
    )
    cuda_build.check(lib, "conv_i8", err, "conv_i8")
    conv_i8.launches += 1
    return out


conv_i8.launches = 0
