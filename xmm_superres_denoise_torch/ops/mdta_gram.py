"""The Gram side of Restormer's MDTA on hand-written Hopper kernels.

softmax(temperature * q_hat k_hat^T) per image and head, over q and k as the
depthwise convolution leaves them (the first two thirds of `qkv`, NHWC),
with each channel L2-normalised over the pixels and the (d x d) product
contracted over every pixel, with the precision of the port's
`models/restormer.py: MDTA`: the logits f32 from operands in the input's
dtype, the temperature rounded to it, the softmax in f32 and rounded to it
once.

* `mdta_gram(qkv, num_heads, temperature)` is the entry point;
  `models/restormer.py: MDTA` calls it and multiplies the (b, heads, d, d)
  result into v. Where it goes is decided by what the input shows
  (`route`): a CUDA bf16 `qkv` that needs no gradient (serving, under
  `torch.inference_mode()`), with d = c / heads a multiple of 8 up to 128,
  launches the kernels of `csrc/mdta_gram.cu`; a CPU tensor, any other
  dtype (f32 is the parity class and f32 evaluation), an input that needs a
  gradient (training through autograd) or any other d runs
  `mdta_attention_plain`. A kernel input outside the kernels' range
  (`plan`) raises; there is no fallback. `route_for` is the decision
  itself, from the device type, the dtype, whether a gradient is needed
  and d.
* `mdta_attention_plain` is the composition of PyTorch ops the kernels
  replace: per operand a square, a sum over the pixels, a root, a clamp and
  a divide in the input's dtype, both cast to f32, the f32 product, the
  temperature and the softmax, each a pass over device memory.
* `plan` checks a kernel input and returns what the launch is handed: the
  pixels a stage (R), the channels a TMA box (W), the split of the pixels
  into chunks, one CTA each, and the strides.
* `mdta_gram.launches` counts calls on the kernels' path (each launches the
  Gram kernel and the softmax kernel once).

What bounds the kernels and how their design meets that are in the note at
the top of `csrc/mdta_gram.cu`. The library is built at first use
(`ops/cuda_build.py`) and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build
from .dense_block import grad_needed

Tensor = torch.Tensor

MAX_HEAD = 128      # d: A in two 64-row halves, B 128 wide
STAGE_ELEMS = 4608  # d x R of one operand a stage: 18 KB of q and k together
MIN_STAGES = 4      # stages a chunk at least, so the ring fills
PARTIAL_SHARE = 10  # a chunk's pixels over (d + 2): the partials under a tenth of the bytes read
CTAS_PER_SM = 2     # the largest calls put at least this many CTAs on each SM

_I, _P, _L = cuda_build.I, cuda_build.P, ctypes.c_longlong
_SIGNATURES = {"mdta_gram": [_I, _P, _P, _P, _P, *[_I] * 8, _L, _L, _P]}


def heads_first(t: Tensor, num_heads: int) -> Tensor:
    """(b, h, w, heads * d) -> (b, heads, d, h * w): channels as rows,
    pixels as the contracted axis (a view)."""
    b, h, w, c = t.shape
    return t.reshape(b, h * w, num_heads, c // num_heads).permute(0, 2, 3, 1)


def l2_normalize(t: Tensor) -> Tensor:
    """Each row over the last axis divided by its L2 norm, clamped at 1e-12,
    in t's dtype."""
    norm = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    return t / torch.clamp(norm, min=1e-12)


def mdta_attention_plain(qkv: Tensor, num_heads: int, temperature: Tensor) -> Tensor:
    """softmax(temperature * q_hat k_hat^T) (b, heads, d, d) in qkv's dtype,
    as MDTA computes it in PyTorch ops."""
    q, k, _ = qkv.chunk(3, dim=-1)
    q, k = l2_normalize(heads_first(q, num_heads)), l2_normalize(heads_first(k, num_heads))
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
    attn = attn * temperature.to(qkv.dtype)
    return torch.softmax(attn, dim=-1).to(qkv.dtype)


def route_for(device_type: str, dtype: torch.dtype, needs_grad: bool, d: int) -> str:
    """'kernel' for a CUDA bf16 input that needs no gradient with d a
    multiple of 8 up to 128, else 'plain'."""
    kernel = (device_type == "cuda" and dtype == torch.bfloat16 and not needs_grad
              and d % 8 == 0 and 8 <= d <= MAX_HEAD)
    return "kernel" if kernel else "plain"


def route(qkv: Tensor, num_heads: int, temperature: Tensor) -> str:
    """`route_for` of qkv's device and dtype, whether autograd records a
    function of qkv or the temperature here (`ops/dense_block.py:
    grad_needed`), and d."""
    return route_for(qkv.device.type, qkv.dtype, grad_needed(qkv, temperature),
                     qkv.shape[-1] // 3 // num_heads)


class Plan(NamedTuple):
    """What a launch is handed."""

    batch: int
    pixels: int        # h * w
    channels: int      # c: q's, k's and v's each
    heads: int
    rows: int          # R: pixels a stage
    width: int         # W: channels a box, the widest of 64, 32, 16, 8 dividing d and N
    chunk_px: int      # pixels a chunk, a multiple of R
    chunks: int        # chunks an (image, head): one CTA each
    pixel_stride: int  # elements between pixels
    batch_stride: int  # elements between images


def plan(qkv: Tensor, num_heads: int, sms: int) -> Plan:
    """Check that the kernels take this input and say how they are launched
    on a card of `sms` SMs.

    Raises ValueError outside the kernels' range: qkv (b, h, w, 3c) bf16,
    not empty, d = c / heads a multiple of 8 up to 128, channels
    contiguous, pixels at one stride (16-byte multiples, as images), a
    16-byte aligned start.

    The chunks: enough that b * heads * chunks >= 2 * sms CTAs, each a whole
    number of stages, at least 4 stages and 10 (d + 2) pixels (so the f32
    partials, d^2 + 2d a chunk, stay under a tenth of the bytes read)."""
    if qkv.dim() != 4:
        raise ValueError(f"mdta_gram takes qkv (b, h, w, 3c), got {tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"mdta_gram kernel reads bf16 qkv, got {qkv.dtype}")
    if qkv.data_ptr() % 16:
        raise ValueError("mdta_gram kernel reads qkv from a 16-byte aligned start, got "
                         f"address % 16 = {qkv.data_ptr() % 16}")
    return _plan(tuple(qkv.shape), qkv.stride(), num_heads, sms)


@functools.lru_cache(maxsize=256)
def _plan(shape: tuple, strides: tuple, num_heads: int, sms: int) -> Plan:
    """`plan` of a bf16 qkv at an aligned start, from its shape and strides
    (kept: a forward asks for the same few shapes on every call)."""
    b, h, w, c3 = shape
    if c3 % 3 or (c3 // 3) % num_heads:
        raise ValueError(f"mdta_gram: 3c = {c3} channels do not split into q, k, v of "
                         f"{num_heads} heads")
    c = c3 // 3
    d = c // num_heads
    if d % 8 or not 8 <= d <= MAX_HEAD:
        raise ValueError(f"mdta_gram kernel takes a head width d a multiple of 8 up to "
                         f"{MAX_HEAD}, got d={d}")
    px = h * w
    if b == 0 or px == 0:
        raise ValueError(f"mdta_gram kernel takes at least one image and pixel, got "
                         f"{shape}")
    sp = strides[2] if w > 1 else strides[1] if h > 1 else c3
    sb = strides[0] if b > 1 else px * sp
    if (strides[3] != 1 or (h > 1 and w > 1 and strides[1] != w * sp) or sp < c3
            or sp % 8 or sb % 8):
        raise ValueError("mdta_gram kernel reads pixels of contiguous channels at one stride, "
                         f"16-byte multiples, got strides {strides}")
    rows = min(256, max(16, STAGE_ELEMS // d // 16 * 16))
    n = next(nn for nn in (48, 64, 96, 128) if d <= nn)
    width = next(wd for wd in (64, 32, 16, 8) if d % wd == 0 and n % wd == 0)
    wanted = -(-CTAS_PER_SM * sms // (b * num_heads))
    least = max(MIN_STAGES * rows, PARTIAL_SHARE * (d + 2))
    stages = max(-(-least // rows), px // (wanted * rows))
    chunk_px = min(stages, -(-px // rows)) * rows
    return Plan(b, px, c, num_heads, rows, width, chunk_px, -(-px // chunk_px), sp, sb)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(qkv: Tensor, num_heads: int, temperature: Tensor) -> Tensor:
    dev = cuda_build.device_index(qkv)
    pl = plan(qkv, num_heads, _sms(dev))
    temp = temperature.detach().to(qkv.device, torch.bfloat16).reshape(-1).contiguous()
    if temp.numel() != num_heads:
        raise ValueError(f"mdta_gram: a temperature a head, got {tuple(temperature.shape)}")
    d = pl.channels // num_heads
    out = torch.empty((pl.batch, num_heads, d, d), dtype=torch.bfloat16, device=qkv.device)
    ws = torch.empty((pl.batch * num_heads * pl.chunks, d * d + 2 * d), dtype=torch.float32,
                     device=qkv.device)
    lib = cuda_build.library("mdta_gram", _SIGNATURES)
    err = lib.mdta_gram(dev, qkv.data_ptr(), temp.data_ptr(), out.data_ptr(), ws.data_ptr(),
                        pl.batch, pl.pixels, pl.channels, num_heads, pl.rows, pl.width,
                        pl.chunk_px, pl.chunks, pl.pixel_stride, pl.batch_stride,
                        cuda_build.stream_of(qkv))
    cuda_build.check(lib, "mdta_gram", err, "mdta_gram")
    mdta_gram.launches += 1
    return out


def mdta_gram(qkv: Tensor, num_heads: int, temperature: Tensor) -> Tensor:
    """softmax(temperature * q_hat k_hat^T), (b, heads, d, d) in qkv's dtype:
    on the kernels for a CUDA bf16 qkv that needs no gradient with d a
    multiple of 8 up to 128, else the plain version (module docstring)."""
    if route(qkv, num_heads, temperature) == "plain":
        return mdta_attention_plain(qkv, num_heads, temperature)
    return _launch(qkv, num_heads, temperature)


mdta_gram.launches = 0
