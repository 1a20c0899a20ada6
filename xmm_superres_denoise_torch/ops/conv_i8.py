"""K3: the s8 x s8 -> s32 SAME 3x3 convolution on a hand-written Hopper
kernel, with the int8 forward's per-convolution epilogue inside it.

Replaces `ops/int8_forward.py::_conv_i8` of the JAX package, the XLA int8
convolution with int32 accumulation that carries every convolution of int8
serving, and the elementwise epilogue that XLA fuses into it (dequantise,
bias, LeakyReLU, residual, requantise); PyTorch has no CUDA int8
convolution.

* `conv_i8(x8, w8, epilogue=None, residual=None, out=None, codes=None)`:
  x8 (B, H, W, Cin) int8 NHWC, w8 (3, 3, Cin, Cout) int8 HWIO or a
  `PackedI8` from `pack_weights`. Without an epilogue it returns the raw
  (B, H, W, Cout) int32 sums; with an `Epilogue` it returns what that
  epilogue writes: its dtype's values, its int8 codes, or both as
  (values, codes). `out` and `codes` may be views to write the values and
  the codes into (a channel slice of an int8 concat buffer); `residual` is
  the (B, H, W, Cout) tensor of a residual epilogue. For a CUDA tensor it
  launches the kernel of `csrc/conv_i8.cu` or raises; there is no
  fallback. For a CPU tensor it runs the plain version. x8 may be a
  channel prefix of a wider NHWC buffer (`buf[..., :cin]`): the kernel
  reads it in place.
* Routes (`route`): Cin % 128 == 0 runs the s8 `wgmma` level fed by TMA
  (`csrc/conv3x3_wgmma.cuh`), any other Cin % 32 == 0 (conv_first) the
  `mma.sync` Tile128 (`csrc/conv3x3_igemm.cuh`).
* `pack_weights` lays the weights out once as (9, Cout, Cin32), Cin zero-
  padded to a multiple of 32 (the s8 mma's K depth); the wrapper pads the
  activations' channels to match, which adds zeros to every sum. Raw HWIO
  weights are packed on every call.
* Plain versions: `conv_i8_reference`, `F.conv2d` in float64, exact here
  (|sum| <= 9 * 640 * 127^2 < 2^53), cast to int32; `Epilogue.apply`, the
  torch epilogue of `ops/int8_forward.py` op for op.
* `conv_i8.launches` counts kernel launches, raw and fused alike.
* K3 serves inference only: with grad enabled and a float operand (the
  residual, the epilogue's scales or bias) that requires grad it raises
  `RuntimeError` (`refuse_grad`) on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .dense_block import refuse_grad
from .precision import lrelu, scalar_like

Tensor = torch.Tensor

_K_DEPTH = 32  # bytes of K per s8 mma k-step
_WGMMA_CHUNK = 128  # input channels per chunk of the wgmma route
_OUT_CHANNELS = 128  # output channels per block
_MAX_GRID_Z = 65535
_I, _P, _F = cuda_build.I, cuda_build.P, cuda_build.F32
_SIGNATURES = {
    "conv_i8": [_I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _I, _F,
                _P, _I, _F, _F, _P],
    "conv_i8_wgmma_route": [_I],
    "conv_i8_smem_bytes": [_I],
}


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


def route(cin: int) -> str:
    """The kernel a convolution over `cin` input channels runs on the card:
    "wgmma" (Cin % 128 == 0) or "mma.sync" (conv_first's padded 32)."""
    return "wgmma" if (cin + -cin % _K_DEPTH) % _WGMMA_CHUNK == 0 else "mma.sync"


def quantize_i8(x: Tensor, scale: float) -> Tensor:
    """-> int8 with a per-tensor symmetric scale (x ~ x8 * scale / 127):
    round half to even (as `jnp.round`), clip to +-127."""
    xf = x.float()
    q = torch.round(xf * scalar_like(xf, 127.0 / scale))
    return torch.clamp(q, -127, 127).to(torch.int8)


class Epilogue:
    """The int8 forward's epilogue of one convolution, made once per
    convolution: dequantise with per-output-channel `c_o` and `bias` (both
    (Cout,) f32) into `dtype` (f32 or bf16), then optionally LeakyReLU with
    `slope`, a residual `v * res_scale + r` (`res_scale` 1: `r + v`, the same
    bits), and requantisation to int8 codes with the activation scale
    `qscale`, written instead of the values or, with `values`, beside them.
    `apply` is the plain version, which requantises with `quantize`; the
    kernel takes the scalars as `kernel_scalars` holds them, rounded once
    here as torch rounds them (`scalar_like`)."""

    def __init__(self, c_o: Tensor, bias: Tensor, dtype: torch.dtype,
                 slope: Optional[float] = None, res_scale: Optional[float] = None,
                 qscale: Optional[float] = None, values: bool = False,
                 quantize=quantize_i8):
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"conv_i8 epilogues are f32 or bf16, got {dtype}")
        c_o, bias = torch.as_tensor(c_o), torch.as_tensor(bias)
        if c_o.dim() != 1 or bias.shape != c_o.shape:
            raise ValueError(f"c_o and bias must be (Cout,), got {tuple(c_o.shape)}, "
                             f"{tuple(bias.shape)}")
        self.c_o = c_o.to(torch.float32).contiguous()
        self.bias = bias.to(self.c_o.device, torch.float32).contiguous()
        self.dtype, self.slope, self.res_scale, self.qscale = dtype, slope, res_scale, qscale
        self.values = qscale is None or values  # writes its dtype values
        self.quantize = quantize
        one = torch.empty((), dtype=dtype)
        self.kernel_scalars = (
            float(scalar_like(one, slope)) if slope is not None else 0.0,
            float(scalar_like(one, res_scale)) if res_scale is not None else 0.0,
            float(scalar_like(one.float(), 127.0 / qscale)) if qscale is not None else 0.0,
        )

    def apply(self, y32: Tensor, residual: Optional[Tensor] = None):
        """The plain version: the torch epilogue on the int32 sums, one torch
        op per rounding; returns the values, the codes or (values, codes)."""
        v = (y32.float() * self.c_o + self.bias).to(self.dtype)
        if self.slope is not None:
            v = lrelu(v, self.slope)
        if self.res_scale is not None:
            v = v * scalar_like(v, self.res_scale) + residual
        if self.qscale is None:
            return v
        q = self.quantize(v, self.qscale)
        return (v, q) if self.values else q


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


def _pair_stride(t: Tensor, what: str) -> int:
    """The pixel stride of `t`, which the kernel reads or writes two
    channels at a time: refuse uneven pixels, an odd stride or a base off a
    two-element boundary."""
    stride = _pixel_stride(t)
    if stride < 0 or stride % 2 or t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"conv_i8 kernel cannot take this {what}: it needs evenly spaced NHWC "
                         f"pixels, an even pixel stride and a base on a {2 * t.element_size()}-"
                         f"byte boundary (stride {t.stride()}, address {t.data_ptr() % 16} mod 16)")
    return stride


def _check_apart(x8: Tensor, out: Tensor) -> None:
    """Refuse an output that shares memory with the channels x8 reads: the
    kernel writes while other blocks still read. Disjoint channel slices of
    one buffer, as a concat level writes them, are fine."""
    if out.untyped_storage().data_ptr() != x8.untyped_storage().data_ptr():
        return
    px = x8.stride(2) * x8.element_size()
    span = out.shape[3] * out.element_size()
    off = (out.data_ptr() - x8.data_ptr()) % px
    if out.stride(2) * out.element_size() != px or off < x8.shape[3] or off + span > px:
        raise ValueError("conv_i8 output overlaps the input channels it reads")


def _check_args(x8: Tensor, cout: int, epilogue: Optional[Epilogue], residual, out,
                codes) -> tuple:
    """Shapes and dtypes of the epilogue's operands and outputs, on every
    device; returns (values dtype or None, whether it writes codes)."""
    b, h, w, _ = x8.shape
    values = torch.int32 if epilogue is None else epilogue.dtype if epilogue.values else None
    writes_codes = epilogue is not None and epilogue.qscale is not None
    if epilogue is not None:
        if epilogue.c_o.numel() != cout:
            raise ValueError(f"conv_i8 epilogue has {epilogue.c_o.numel()} channels, weights {cout}")
        if epilogue.c_o.device != x8.device or epilogue.bias.device != x8.device:
            raise ValueError(f"conv_i8 epilogue must be on {x8.device}")
    wants_residual = epilogue is not None and epilogue.res_scale is not None
    if wants_residual != (residual is not None):
        raise ValueError("conv_i8 takes a residual exactly when its epilogue has a res_scale")
    if residual is not None and (tuple(residual.shape) != (b, h, w, cout)
                                 or residual.dtype != epilogue.dtype
                                 or residual.device != x8.device):
        raise ValueError(f"conv_i8 residual must be {(b, h, w, cout)} {epilogue.dtype} on "
                         f"{x8.device}, got {tuple(residual.shape)} {residual.dtype}")
    for name, t, dtype in (("out", out, values), ("codes", codes, torch.int8 if writes_codes else None)):
        if t is None:
            continue
        if dtype is None:
            raise ValueError(f"conv_i8 with this epilogue writes no {name}")
        if tuple(t.shape) != (b, h, w, cout) or t.dtype != dtype or t.device != x8.device:
            raise ValueError(f"conv_i8 {name} must be {(b, h, w, cout)} {dtype} on {x8.device}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if residual is not None and \
                t.untyped_storage().data_ptr() == residual.untyped_storage().data_ptr():
            raise ValueError(f"conv_i8 residual shares memory with {name}")  # read as read-only
    return values, writes_codes


def _result(values, codes, epilogue: Optional[Epilogue]):
    """What conv_i8 returns: the values, the codes, or both."""
    if epilogue is None or epilogue.qscale is None:
        return values
    return (values, codes) if epilogue.values else codes


def conv_i8(x8: Tensor, w8: Union[Tensor, PackedI8], epilogue: Optional[Epilogue] = None,
            residual: Optional[Tensor] = None, out: Optional[Tensor] = None,
            codes: Optional[Tensor] = None):
    """SAME 3x3 s8 convolution, NHWC in; int32 NHWC out, or what the
    epilogue writes (module docstring)."""
    if epilogue is None:
        refuse_grad("conv_i8", residual)
    else:
        refuse_grad("conv_i8", residual, epilogue.c_o, epilogue.bias)
    packed = w8 if isinstance(w8, PackedI8) else pack_weights(w8, x8.device)
    if x8.dim() != 4 or x8.dtype != torch.int8:
        raise TypeError(f"conv_i8 takes NHWC int8, got {tuple(x8.shape)} {x8.dtype}")
    cin, cout = packed.hwio.shape[2], packed.hwio.shape[3]
    if x8.shape[3] != cin:
        raise ValueError(f"conv_i8: input has {x8.shape[3]} channels, weights {cin}")
    values, writes_codes = _check_args(x8, cout, epilogue, residual, out, codes)
    if x8.device.type == "cpu":
        y = conv_i8_reference(x8, packed.hwio)
        if epilogue is None:
            return y if out is None else out.copy_(y)
        y = epilogue.apply(y, residual)
        if not writes_codes:
            v, q = y, None
        elif values is None:
            v, q = None, y
        else:
            v, q = y
        if out is not None:
            v = out.copy_(v)
        if codes is not None:
            q = codes.copy_(q)
        return _result(v, q, epilogue)
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
    if packed.kernel.device != x8.device or not packed.kernel.is_contiguous() \
            or packed.kernel.data_ptr() % 16:
        raise ValueError(f"conv_i8 weights must be contiguous and 16-byte aligned on {x8.device}")
    if out is None and values is not None:
        out = torch.empty((b, h, w, cout), dtype=values, device=x8.device)
    if codes is None and writes_codes:
        codes = torch.empty((b, h, w, cout), dtype=torch.int8, device=x8.device)
    out_ptr, out_stride, codes_ptr, codes_stride = 0, 0, 0, 0
    if out is not None:
        out_ptr, out_stride = out.data_ptr(), _pair_stride(out, "output")
        _check_apart(x8, out)
    if codes is not None:
        codes_ptr, codes_stride = codes.data_ptr(), _pair_stride(codes, "codes output")
        _check_apart(x8, codes)
    if epilogue is None:
        c_o, bias, scalars = 0, 0, (0.0, 0.0, 0.0)
    else:
        c_o, bias, scalars = epilogue.c_o.data_ptr(), epilogue.bias.data_ptr(), epilogue.kernel_scalars
        if c_o % 8 or bias % 8:
            raise ValueError("conv_i8 epilogue c_o and bias must lie on 8-byte boundaries")
    res, res_stride = 0, 0
    if residual is not None:
        res, res_stride = residual.data_ptr(), _pair_stride(residual, "residual")
    slope, alpha, qmul = scalars
    lib = cuda_build.library("conv_i8", _SIGNATURES)
    err = lib.conv_i8(
        cuda_build.device_index(x8), x8.data_ptr(), b, h, w, stride, cin_k,
        packed.kernel.data_ptr(), cout, out_ptr, out_stride, codes_ptr, codes_stride,
        int(epilogue is None), int(epilogue is not None and epilogue.dtype == torch.bfloat16),
        c_o, bias, int(epilogue is not None and epilogue.slope is not None), slope, res,
        res_stride, alpha, qmul, cuda_build.stream_of(x8),
    )
    cuda_build.check(lib, "conv_i8", err, "conv_i8")
    conv_i8.launches += 1
    return _result(out, codes, epilogue)


conv_i8.launches = 0
