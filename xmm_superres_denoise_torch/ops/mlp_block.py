"""The MLP half of the transformer zoo's blocks on a hand-written Hopper kernel.

x + fc2(GELU(fc1(LayerNorm(x)))) over tokens (..., C), with the precision
of the port's `models/swin_common.py` (`LayerNorm`, `Mlp`, `linear`):
LayerNorm's statistics and affine step in f32 on the parameters rounded to
the input's dtype, one rounding at the end; each product in the input
dtype with f32 sums, rounded, then its bias added and rounded; the exact
(erf) GELU; the residual add rounded.

* `mlp_block(x, norm, mlp)` is the entry point; `models/swin_common.py:
  mlp_residual` calls it for SwinIR's, SwinFIR's and DRCT's Swin blocks and
  HAT's HAB and OCAB. Where it goes is decided by what the input shows
  (`route`): a CUDA bf16 input that needs no gradient (serving, under
  `torch.inference_mode()`), with C <= 192 channels and a hidden width H <=
  768, launches the kernel of `csrc/mlp_block.cu`; a CPU tensor, any other
  dtype (f32 is the parity class and f32 evaluation), an input that needs a
  gradient (training through autograd) or a wider block (DRCT's 212 to 308
  channels) runs `mlp_block_plain`. A kernel input outside the kernel's
  range (`plan`) raises; there is no fallback. `route_for` is the decision
  itself, from the device type, the dtype, whether a gradient is needed and
  the widths.
* `mlp_block_plain` is the composition of PyTorch ops the kernel fuses:
  `x + mlp(norm(x))`, each cast, product, bias add, GELU and the residual
  add a pass over device memory (the hidden T x H among them).
* `plan` checks a kernel input and returns what the launch is handed.
* `weights_of` lays the parameters out as the kernel reads them: each
  48-wide chunk of hidden units as its shared-memory image (W1 rows and W2
  columns, zero-padded to 192 channels, with the 32-byte swizzle), and the
  vectors (gamma, beta, b2, b1) in bf16. It is made once per parameter
  version and kept beside the module.
* `mlp_block.launches` counts kernel launches (one per call on the
  kernel's path).

What bounds the kernel and how its design meets that are in the note at
the top of `csrc/mlp_block.cu`. The library is built at first use
(`ops/cuda_build.py`) and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import cuda_build
from .dense_block import grad_needed

Tensor = torch.Tensor

MAX_CHANNELS = 192  # C: fc1's K and fc2's N padded to 192
MAX_HIDDEN = 768    # H: at most 16 chunks
CHUNK = 48          # hidden units a chunk: W1 rows and W2 columns of one ring stage
_STEP = 16          # channels of one k16 step of wgmma: one 32-byte swizzled region

_SIGNATURES = {
    "mlp_block": [cuda_build.I, *[cuda_build.P] * 4, ctypes.c_longlong, cuda_build.I,
                  cuda_build.I, cuda_build.F32, cuda_build.P],
}


def mlp_block_plain(x: Tensor, norm: nn.Module, mlp: nn.Module) -> Tensor:
    """x + mlp(norm(x)): the blocks' MLP half as PyTorch ops, each layer
    applied as the model applies it."""
    return x + mlp(norm(x))


def route_for(device_type: str, dtype: torch.dtype, needs_grad: bool, channels: int,
              hidden: int) -> str:
    """'kernel' for a CUDA bf16 input that needs no gradient with C <= 192
    and H <= 768, else 'plain'."""
    kernel = (device_type == "cuda" and dtype == torch.bfloat16 and not needs_grad
              and channels <= MAX_CHANNELS and hidden <= MAX_HIDDEN)
    return "kernel" if kernel else "plain"


def _params(norm: nn.Module, mlp: nn.Module):
    return (norm.scale, norm.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias)


def route(x: Tensor, norm: nn.Module, mlp: nn.Module) -> str:
    """`route_for` of x's device and dtype, whether autograd records a
    function of x or the parameters here (`ops/dense_block.py:
    grad_needed`), C and H."""
    return route_for(x.device.type, x.dtype, grad_needed(x, *_params(norm, mlp)), x.shape[-1],
                     mlp.fc1.weight.shape[0])


class Plan(NamedTuple):
    """What a launch is handed."""

    tokens: int    # T, the rows of x
    channels: int  # C
    hidden: int    # H
    chunks: int    # ceil(H / 48)


def plan(x: Tensor, norm: nn.Module, mlp: nn.Module) -> Plan:
    """Check that the kernel takes this input and these layers and say how
    it is launched.

    Raises ValueError outside the kernel's range: x bf16, contiguous and
    16-byte aligned, of an even C <= 192 channels; fc1 (H, C) and fc2 (C, H)
    with H <= 768; LayerNorm over C."""
    if x.dim() < 2:
        raise ValueError(f"mlp_block takes tokens (..., C), got {tuple(x.shape)}")
    c = x.shape[-1]
    h = mlp.fc1.weight.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"mlp_block kernel reads bf16 tokens, got {x.dtype}")
    if not (2 <= c <= MAX_CHANNELS and c % 2 == 0):
        raise ValueError(f"mlp_block kernel takes an even number of channels 2 <= C <= "
                         f"{MAX_CHANNELS} (a pair of channels to a 32-bit load), got C={c}")
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"mlp_block kernel takes a hidden width 1 <= H <= {MAX_HIDDEN}, got H={h}")
    if (tuple(mlp.fc1.weight.shape) != (h, c) or tuple(mlp.fc2.weight.shape) != (c, h)
            or tuple(norm.scale.shape) != (c,) or tuple(norm.bias.shape) != (c,)):
        raise ValueError(f"mlp_block: layers must be LayerNorm({c}), fc1 ({h}, {c}) and fc2 "
                         f"({c}, {h}), got {tuple(norm.scale.shape)}, "
                         f"{tuple(mlp.fc1.weight.shape)}, {tuple(mlp.fc2.weight.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mlp_block kernel reads x as contiguous rows from a 16-byte aligned "
                         f"start, got strides {x.stride()}, address % 16 = {x.data_ptr() % 16}")
    return Plan(x.numel() // c, c, h, -(-h // CHUNK))


def swizzle32(regions: Tensor) -> Tensor:
    """Regions (..., rows, 16) of bf16 as wgmma reads them with the 32-byte
    swizzle: in rows r with (r >> 2) & 1 the two 16-byte halves swap."""
    rows = regions.shape[-2]
    swap = ((torch.arange(rows, device=regions.device) >> 2) & 1).bool()
    halves = regions.unflatten(-1, (2, 8))
    return torch.where(swap[:, None, None], halves.flip(-2), halves).flatten(-2)


def _layout(scale: Tensor, shift: Tensor, w1: Tensor, b1: Optional[Tensor], w2: Tensor,
            b2: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """(image, vec) from LayerNorm's scale and bias and fc1's and fc2's
    weights and biases (torch layout: fc1 (H, C), fc2 (C, H)), all rounded
    to bf16:

    * image (chunks, 18432) bf16: per chunk of 48 hidden units, W1's 48
      rows as 12 regions (one a k16 step of channels) of 48 x 16, then W2's
      48 columns as 3 regions (one a k16 step of hidden units) of 192
      output channels x 16, channels padded with zeros to 192 and hidden
      units to whole chunks, each region with the 32-byte swizzle;
    * vec: gamma, beta and b2 (192 each, zeros past C), then b1 (chunks x 48,
      zeros past H)."""
    h, c = w1.shape
    n = -(-h // CHUNK)
    hp, kp = n * CHUNK, MAX_CHANNELS
    bf = dict(dtype=torch.bfloat16, device=w1.device)
    w1p = torch.zeros((hp, kp), **bf)
    w1p[:h, :c] = w1
    w2p = torch.zeros((kp, hp), **bf)
    w2p[:c, :h] = w2
    w1r = swizzle32(w1p.view(n, CHUNK, kp // _STEP, _STEP).permute(0, 2, 1, 3))
    w2r = swizzle32(w2p.view(kp, n, CHUNK // _STEP, _STEP).permute(1, 2, 0, 3))
    image = torch.cat([w1r.reshape(n, -1), w2r.reshape(n, -1)], dim=1).contiguous()
    vec = torch.zeros(3 * kp + hp, **bf)
    vec[:c] = scale
    vec[kp:kp + c] = shift
    if b2 is not None:
        vec[2 * kp:2 * kp + c] = b2
    if b1 is not None:
        vec[3 * kp:3 * kp + h] = b1
    return image, vec


_CACHE: "weakref.WeakKeyDictionary[nn.Module, tuple]" = weakref.WeakKeyDictionary()


def _stamp(tensors) -> Optional[tuple]:
    """What identifies the parameters' values: each one's storage, version,
    dtype and device; None where a tensor keeps no version counter (one
    made under `torch.inference_mode()`), which is then never cached."""
    try:
        return tuple(None if t is None else (t.data_ptr(), t._version, t.dtype, t.device)
                     for t in tensors)
    except RuntimeError:
        return None


def cached_layout(cache: "weakref.WeakKeyDictionary[nn.Module, tuple]", owner: nn.Module,
                  params, device: torch.device, layout) -> Tuple[Tensor, Tensor]:
    """`layout(*params)` of the parameters in bf16 on `device`, made once per
    parameter version (`_stamp`) and kept in `cache` beside `owner`."""
    key = _stamp(params)
    hit = cache.get(owner)
    if key is not None and hit is not None and hit[0] == key and hit[1][0].device == device:
        return hit[1]
    made = layout(*[None if t is None else t.detach().to(device, torch.bfloat16) for t in params])
    if key is not None:
        cache[owner] = (key, made)
    return made


def weights_of(norm: nn.Module, mlp: nn.Module, device: torch.device) -> Tuple[Tensor, Tensor]:
    """`_layout` of the layers' parameters in bf16 on `device`, made once per
    parameter version and kept beside `mlp`."""
    return cached_layout(_CACHE, mlp, _params(norm, mlp), device, _layout)


def _launch(x: Tensor, norm: nn.Module, mlp: nn.Module) -> Tensor:
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    pl = plan(x, norm, mlp)
    out = torch.empty_like(x)
    if pl.tokens == 0:
        return out
    image, vec = weights_of(norm, mlp, x.device)
    lib = cuda_build.library("mlp_block", _SIGNATURES)
    err = lib.mlp_block(cuda_build.device_index(x), x.data_ptr(), out.data_ptr(), image.data_ptr(),
                        vec.data_ptr(), pl.tokens, pl.channels, pl.chunks, float(norm.eps),
                        cuda_build.stream_of(x))
    cuda_build.check(lib, "mlp_block", err, "mlp_block")
    mlp_block.launches += 1
    return out


def mlp_block(x: Tensor, norm: nn.Module, mlp: nn.Module) -> Tensor:
    """x + mlp(norm(x)): on the kernel for a CUDA bf16 input that needs no
    gradient at C <= 192 and H <= 768, else the plain version (module
    docstring)."""
    if route(x, norm, mlp) == "plain":
        return mlp_block_plain(x, norm, mlp)
    return _launch(x, norm, mlp)


mlp_block.launches = 0
