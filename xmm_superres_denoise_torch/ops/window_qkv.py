"""The qkv side of the transformer zoo's Swin blocks on a hand-written Hopper kernel.

linear(qkv, window_partition(roll(norm(x), -shift))) over tokens (B, H * W,
C), returning the (B * nW, N, 3C) rows that `WindowAttention` splits into
q, k and v, with the precision of the port's `models/swin_common.py`
(`LayerNorm`, `linear`): LayerNorm's statistics and affine step in f32 on
the parameters rounded to the input's dtype, one rounding at the end; the
product in the input dtype with f32 sums, rounded, then its bias added and
rounded.

* `window_qkv(x, x_size, window, shift, norm, qkv)` is the entry point:
  `models/swin_common.py: SwinTransformerBlock` calls it with its `norm1`,
  HAT's HAB with `norm=None` (it hands over the image it normalised for its
  CAB). Where it goes is decided by what the input shows (`route`): a CUDA
  bf16 input that needs no gradient (serving, under
  `torch.inference_mode()`), with an even C <= 320, N = window^2 <= 256, H
  and W multiples of the window and 0 <= shift < window, launches the
  kernel of `csrc/window_qkv.cu`; a CPU tensor, any other dtype (f32 is the
  parity class and f32 evaluation), an input that needs a gradient
  (training through autograd) or anything outside that range runs
  `window_qkv_plain`. A kernel input the kernel does not take (`plan`)
  raises; there is no fallback. `route_for` is the decision itself.
* `window_qkv_plain` is the composition of PyTorch ops the kernel fuses, the
  ops the blocks ran before it: the norm (its f32 cast, LayerNorm and cast
  back), `torch.roll` in shifted blocks, the partition's permute copy, the
  GEMM and the bias add, each a pass over device memory.
* `plan` checks a kernel input and returns what the launch is handed.
* `weights_of` lays the parameters out as the kernel reads them: each
  64-column chunk of W_qkv as its shared-memory image (rows of C channels
  zero-padded to 16 `k_steps(C)`, in k16 regions with the 32-byte swizzle,
  3C padded with zero rows to whole chunks), and the vectors (gamma, beta,
  bias) in bf16. It is made once per parameter version and kept beside
  the qkv layer.
* `window_qkv.launches` counts kernel launches (one per call on the
  kernel's path).

What bounds the kernel and how its design meets that are in the note at
the top of `csrc/window_qkv.cu`. The library is built at first use
(`ops/cuda_build.py`) and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build
from .dense_block import grad_needed
from .mlp_block import cached_layout, swizzle32

Tensor = torch.Tensor

MAX_CHANNELS = 320  # C: the product's K padded to 16 k_steps(C) <= 320
MAX_TOKENS = 256    # N = window^2, as the window attention kernel takes
CHUNK = 64          # output columns a chunk: one ring stage
_STEP = 16          # channels of one k16 step of wgmma: one 32-byte swizzled region
# the kernel's instances: k16 steps of the product (exact at C 180 to 308;
# a narrower C runs the least on zeros)
K_STEPS = (12, 14, 16, 18, 20)

_I = cuda_build.I
_SIGNATURES = {
    "window_qkv": [_I, *[cuda_build.P] * 4, ctypes.c_longlong, *[_I] * 9, cuda_build.F32,
                   cuda_build.P],
}


def window_qkv_plain(x: Tensor, x_size: Tuple[int, int], window: int, shift: int,
                     norm: Optional[nn.Module], qkv: nn.Linear) -> Tensor:
    """(B * nW, N, 3C): the norm (if any) over tokens (B, H * W, C), the
    image rolled by -shift, cut into row-major windows, and the qkv Dense
    (`models/swin_common.py: window_partition` and `linear`) as PyTorch ops."""
    h, w = x_size
    b, _, c = x.shape
    y = (x if norm is None else norm(x)).reshape(b, h, w, c)
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    y = y.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    xw = y.reshape(-1, window * window, c)
    out = F.linear(xw, qkv.weight.to(xw.dtype))
    return out if qkv.bias is None else out + qkv.bias.to(xw.dtype)


def route_for(device_type: str, dtype: torch.dtype, needs_grad: bool, channels: int,
              x_size: Tuple[int, int], window: int, shift: int) -> str:
    """'kernel' for a CUDA bf16 input that needs no gradient with an even C
    <= 320, window^2 <= 256, H and W multiples of the window and 0 <= shift
    < window, else 'plain'."""
    h, w = x_size
    kernel = (device_type == "cuda" and dtype == torch.bfloat16 and not needs_grad
              and channels % 2 == 0 and 2 <= channels <= MAX_CHANNELS
              and 1 <= window * window <= MAX_TOKENS and h % window == 0 and w % window == 0
              and 0 <= shift < window)
    return "kernel" if kernel else "plain"


def _params(norm: Optional[nn.Module], qkv: nn.Linear):
    return (qkv.weight, qkv.bias) + ((norm.scale, norm.bias) if norm is not None else ())


def route(x: Tensor, x_size: Tuple[int, int], window: int, shift: int,
          norm: Optional[nn.Module], qkv: nn.Linear) -> str:
    """`route_for` of x's device and dtype, whether autograd records a
    function of x or the parameters here (`ops/dense_block.py:
    grad_needed`), C and the window geometry."""
    return route_for(x.device.type, x.dtype, grad_needed(x, *_params(norm, qkv)), x.shape[-1],
                     x_size, window, shift)


def k_steps(channels: int) -> int:
    """The k16 steps of the kernel's instance for C channels: the least of
    `K_STEPS` that holds them, the rest zeros."""
    return next(k for k in K_STEPS if _STEP * k >= channels)


class Plan(NamedTuple):
    """What a launch is handed."""

    rows: int      # T = B * H * W, the rows of the output
    channels: int  # C
    k_steps: int   # `k_steps(C)`
    chunks: int    # ceil(3C / 64)
    windows: int   # B * nW


def plan(x: Tensor, x_size: Tuple[int, int], window: int, shift: int,
         norm: Optional[nn.Module], qkv: nn.Linear) -> Plan:
    """Check that the kernel takes this input and these layers and say how
    it is launched.

    Raises ValueError outside the kernel's range: x (B, H * W, C) bf16,
    contiguous, 8-byte aligned (4 at C = 2 mod 4), of an even C <= 320; H
    and W multiples of the window, window^2 <= 256, 0 <= shift < window;
    qkv (3C, C), LayerNorm over C."""
    h, w = x_size
    if x.dim() != 3 or x.shape[1] != h * w:
        raise ValueError(f"window_qkv takes tokens (B, H * W, C) of an H x W = {h} x {w} "
                         f"image, got {tuple(x.shape)}")
    c = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"window_qkv kernel reads bf16 tokens, got {x.dtype}")
    if not (2 <= c <= MAX_CHANNELS and c % 2 == 0):
        raise ValueError(f"window_qkv kernel takes an even number of channels 2 <= C <= "
                         f"{MAX_CHANNELS} (a pair of channels to a 32-bit word), got C={c}")
    if not 1 <= window * window <= MAX_TOKENS:
        raise ValueError(f"window_qkv kernel takes windows of N <= {MAX_TOKENS} tokens, got "
                         f"window {window}")
    if h % window or w % window:
        raise ValueError(f"window_qkv kernel takes an image whose size divides by the window, "
                         f"got {h} x {w} at window {window}")
    if not 0 <= shift < window:
        raise ValueError(f"window_qkv kernel takes a shift 0 <= shift < window, got {shift} at "
                         f"window {window}")
    if (tuple(qkv.weight.shape) != (3 * c, c) or (qkv.bias is not None and tuple(
            qkv.bias.shape) != (3 * c,)) or (norm is not None and (
            tuple(norm.scale.shape) != (c,) or tuple(norm.bias.shape) != (c,)))):
        raise ValueError(f"window_qkv: layers must be LayerNorm({c}) and qkv ({3 * c}, {c}), got "
                         f"{tuple(qkv.weight.shape)}")
    align = 8 if c % 4 == 0 else 4
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"window_qkv kernel reads x as contiguous rows from a {align}-byte "
                         f"aligned start, got strides {x.stride()}, address % {align} = "
                         f"{x.data_ptr() % align}")
    rows = x.shape[0] * h * w
    if rows >= 2**31 - 128:
        raise ValueError(f"window_qkv kernel takes fewer than 2^31 - 128 rows, got {rows}")
    return Plan(rows, c, k_steps(c), -(-3 * c // CHUNK), rows // (window * window))


def _layout(weight: Tensor, bias: Optional[Tensor], scale: Optional[Tensor] = None,
            shift: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(image, vec) from the qkv weight (3C, C) and bias and LayerNorm's
    scale and bias, all rounded to bf16:

    * image (chunks, ks x 64 x 16) bf16: per chunk of 64 output
      columns, its 64 weight rows as ks = `k_steps(C)` regions (one a k16
      step of channels) of 64 x 16, channels padded with zeros to 16 ks and
      rows to whole chunks, each region with the 32-byte swizzle;
    * vec: gamma and beta (16 ks each, zeros past C, zeros without a norm),
      then the bias (chunks x 64, zeros past 3C or without a bias)."""
    n3, c = weight.shape
    ks, n = k_steps(c), -(-n3 // CHUNK)
    kp = ks * _STEP
    bf = dict(dtype=torch.bfloat16, device=weight.device)
    wp = torch.zeros((n * CHUNK, kp), **bf)
    wp[:n3, :c] = weight
    image = swizzle32(wp.view(n, CHUNK, ks, _STEP).permute(0, 2, 1, 3)).reshape(n, -1).contiguous()
    vec = torch.zeros(2 * kp + n * CHUNK, **bf)
    if scale is not None:
        vec[:c] = scale
        vec[kp:kp + c] = shift
    if bias is not None:
        vec[2 * kp:2 * kp + n3] = bias
    return image, vec


_CACHE: "weakref.WeakKeyDictionary[nn.Module, tuple]" = weakref.WeakKeyDictionary()


def weights_of(norm: Optional[nn.Module], qkv: nn.Linear,
               device: torch.device) -> Tuple[Tensor, Tensor]:
    """`_layout` of the layers' parameters in bf16 on `device`, made once per
    parameter version (and norm) and kept beside `qkv`."""
    return cached_layout(_CACHE, qkv, _params(norm, qkv), device, _layout)


def _launch(x: Tensor, x_size: Tuple[int, int], window: int, shift: int,
            norm: Optional[nn.Module], qkv: nn.Linear) -> Tensor:
    if not x.is_contiguous() or x.data_ptr() % 8:
        x = x.clone(memory_format=torch.contiguous_format)
    pl = plan(x, x_size, window, shift, norm, qkv)
    out = torch.empty((pl.windows, window * window, 3 * pl.channels), dtype=x.dtype,
                      device=x.device)
    if pl.rows == 0:
        return out
    image, vec = weights_of(norm, qkv, x.device)
    lib = cuda_build.library("window_qkv", _SIGNATURES)
    err = lib.window_qkv(cuda_build.device_index(x), x.data_ptr(), out.data_ptr(),
                         image.data_ptr(), vec.data_ptr(), pl.rows, pl.channels, pl.k_steps,
                         pl.chunks,
                         x_size[0], x_size[1], window, shift, int(norm is not None),
                         int(qkv.bias is not None), float(norm.eps) if norm is not None else 0.0,
                         cuda_build.stream_of(x))
    cuda_build.check(lib, "window_qkv", err, "window_qkv")
    window_qkv.launches += 1
    return out


def window_qkv(x: Tensor, x_size: Tuple[int, int], window: int, shift: int,
               norm: Optional[nn.Module], qkv: nn.Linear) -> Tensor:
    """(B * nW, N, 3C) = linear(qkv, window_partition(roll(norm(x), -shift))):
    on the kernel for a CUDA bf16 input that needs no gradient within its
    range, else the plain version (module docstring)."""
    if route(x, x_size, window, shift, norm, qkv) == "plain":
        return window_qkv_plain(x, x_size, window, shift, norm, qkv)
    return _launch(x, x_size, window, shift, norm, qkv)


window_qkv.launches = 0
