"""Shared Swin-transformer building blocks in PyTorch, NHWC.

The port of the JAX package's `models/swin_common.py`:

* Window partition and reverse are reshapes and permutes of NHWC tensors;
  "patch embed / unembed" is a reshape (`to_tokens`, `to_image`).
* Relative-position indices are numpy constants held as non-persistent
  buffers, so that a model's `state_dict` is exactly its Flax parameter
  set. Shifted-window masks depend on the tensor's size and are made once
  per (size, device) (`shift_mask`).
* Parameters keep their Flax names, so the `state_dict` key of every array
  is its Flax key with '.' for '/' (`utils/weights.py` converts): `nn.Linear`
  holds a Flax `Dense` (weight = kernel transposed), `nn.Conv2d` a Flax
  `Conv` (OIHW = HWIO transposed), `LayerNorm` Flax's `scale` and `bias`.
* Every layer casts its parameters to its input's dtype where it uses them
  (`models/rrdb.py`'s convention): a bf16 input to an f32 model is the
  JAX package's mixed-precision training, and bf16 serving casts the model
  once, so the casts are no-ops.
* Precision follows JAX where it is not the input's dtype: attention logits
  are f32 from bf16 operands (JAX's `preferred_element_type=f32`): in bf16
  serving they are bf16 products on the tensor cores summed in f32 inside
  the fused kernel of `ops/window_attention.py`; on the CPU, in f32 and
  under autograd q and k are upcast and multiplied in f32 (the products of
  bf16 values are exact in f32 either way, only the order of the sum
  differs); the bias and mask are added in f32, the softmax runs in f32 and
  its normalised result is cast back for `attn @ v`; LayerNorm takes its statistics and its affine step in f32 and rounds
  once (Flax's `LayerNorm` promotes to f32); a Python-float scalar meets a
  bf16 tensor rounded to bf16 first (`ops/precision.py: scalar_like`).
* Three routes put a block on hand-written kernels in bf16 serving, each
  with the same roundings as the ops it replaces, which the CPU, f32 and
  autograd run: the qkv side, `norm1`, the cyclic shift, the window
  partition, the qkv Dense and its bias (`ops/window_qkv.py: window_qkv`,
  called by `SwinTransformerBlock` and HAT's HAB, which hand its rows to
  `WindowAttention.attend`); the attention (`attention_core`,
  `ops/window_attention.py`); and the MLP half, `x + mlp(norm2(x))`
  (`mlp_residual`, `ops/mlp_block.py`).
* Tracing: a Swin block's forward, and HAT's HAB, run as four spans
  (`utils/profiling.py: annotate`) that cover the block between them:
  `zoo.qkv` (`window_qkv`), `zoo.attention` (the shift mask, the bias
  gather, `attention_core`), `zoo.proj` (`WindowAttention.project`, the
  window reverse, the reverse roll, the residual add) and `zoo.mlp`
  (`mlp_residual`). `WindowAttention.forward` and the shared helpers open
  none, so HAT's OCAB stays under its own span.
* Initializers: timm's trunc_normal(std 0.02, cut at +-2 absolute) for
  Linear weights and bias tables with zero Linear biases, torch's Conv2d
  default (U(+-1/sqrt(fan_in))) for convolutions, ones and zeros for norms
  (`reset_zoo_parameters`, which each model runs when it is built).

Effective-window rule: when min(input_resolution) <= window_size the
window clamps to min(input_resolution) and the shift drops to 0, where
input_resolution = img_size // patch_size from the config, not the
tensor's size. At the production run configs (img 416, patch 32 -> 13 <
16) SwinIR, SwinFIR and DRCT run window 13 with no shift; the bias-table
shapes depend on it. That holds only at patch 32: at patch 16 (416 / 16 =
26 > 16), as HAT's run config and the benchmark's DRCT configuration set
it, the window stays 16 and every other block shifts by 8.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mlp_block import mlp_block
from ..ops.window_attention import window_attention
from ..ops.window_qkv import window_qkv
from ..utils.profiling import annotate
from .rrdb import _checkpointed, pixel_shuffle

Tensor = torch.Tensor


# --------------------------------------------------------------------------- #
# Window geometry (static precomputation)
# --------------------------------------------------------------------------- #

def effective_window(
    input_resolution: Tuple[int, int], window_size: int, shift_size: int
) -> Tuple[int, int]:
    """(window, shift) after the clamp rule above."""
    if min(input_resolution) <= window_size:
        return min(input_resolution), 0
    return window_size, shift_size


def window_partition(x: Tensor, ws: int) -> Tensor:
    """(B, H, W, C) -> (B*nW, ws, ws, C), row-major windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: Tensor, ws: int, h: int, w: int) -> Tensor:
    """(B*nW, ws, ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position bias index, (wh*ww, wh*ww) int32."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@lru_cache(maxsize=None)
def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """SW-MSA mask, (nW, N, N) float32 of {0, -100}; None for shift == 0."""
    if shift == 0:
        return None
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=16)
def _mask_on(h: int, w: int, ws: int, shift: int, device: str) -> Tensor:
    return torch.from_numpy(shifted_window_mask(h, w, ws, shift)).to(device)


def shift_mask(h: int, w: int, ws: int, shift: int, device) -> Optional[Tensor]:
    """`shifted_window_mask` as an f32 tensor on `device`, made once per
    (size, window, shift, device); None for shift == 0."""
    if shift == 0:
        return None
    return _mask_on(h, w, ws, shift, str(torch.device(device)))


def index_buffer(index: np.ndarray) -> Tensor:
    """An int32 numpy index as the int64 tensor that indexing takes."""
    return torch.from_numpy(np.asarray(index, np.int64))


# --------------------------------------------------------------------------- #
# Layers applied with their parameters cast to the input's dtype
# --------------------------------------------------------------------------- #

def linear(layer: nn.Linear, x: Tensor) -> Tensor:
    """Flax `Dense`: `x @ kernel + bias`, the bias added after the product
    (so a bf16 result is rounded where JAX rounds it)."""
    y = F.linear(x, layer.weight.to(x.dtype))
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def conv(layer: nn.Conv2d, x: Tensor) -> Tensor:
    """Flax `Conv` with SAME padding on an NHWC tensor (through the NCHW
    view, channels_last memory), the bias added after the convolution."""
    w = layer.weight.to(x.dtype)
    k = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2, groups=layer.groups)
    y = y.permute(0, 2, 3, 1)
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def conv2d_torch(features: int, in_channels: int, kernel: int = 3, use_bias: bool = True,
                 groups: int = 1) -> nn.Conv2d:
    """A Flax `conv2d_torch`: torch Conv2d (its default init, U(+-1/sqrt(
    in/groups * k * k))) applied by `conv`."""
    return nn.Conv2d(in_channels, features, kernel, padding=kernel // 2, bias=use_bias,
                     groups=groups)


def dense_torch_init(in_features: int, features: int, use_bias: bool = True) -> nn.Linear:
    """A Flax `dense_torch_init` (trunc_normal(0.02) weight, zero bias, drawn
    by `reset_zoo_parameters`), applied by `linear`."""
    return nn.Linear(in_features, features, bias=use_bias)


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(epsilon=1e-5)` over the last axis, with Flax's
    parameter names (`scale`, `bias`): statistics and the affine step in
    f32 whatever the input's dtype, one rounding to it at the end."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        # the parameters cast to x.dtype and up again: a bf16 model's
        # parameters are bf16 values in the f32 arithmetic, as in Flax
        scale = self.scale.to(x.dtype).float()
        bias = self.bias.to(x.dtype).float()
        y = F.layer_norm(x.float(), (x.shape[-1],), scale, bias, self.eps)
        return y.to(x.dtype)


def _trunc_normal_(t: Tensor, generator=None) -> None:
    """timm's trunc_normal_(std=0.02): cut at +-2 ABSOLUTE (100 sigma)."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0, generator=generator)


def reset_zoo_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter of a zoo model from `generator` with the
    reference's initializers (module docstring); norms' scales and weights
    and Restormer's temperatures are ones, norms' biases zeros."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                _trunc_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
                continue
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())  # fan_in = in/groups * k * k
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
                continue
            for name, p in m.named_parameters(recurse=False):
                if name == "relative_position_bias_table":
                    _trunc_normal_(p, generator)
                else:
                    p.fill_(0.0 if name == "bias" else 1.0)


def drop_path(x: Tensor, rate: float, generator: Optional[torch.Generator]) -> Tensor:
    """Stochastic depth: per-sample binary residual dropout, drawn from
    `generator`; the identity without one (the deterministic forward that
    serving, evaluation and the trainer run) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=generator.device).to(x)
    return x / keep * torch.floor(keep + u)


def mlp_residual(x: Tensor, norm: nn.Module, mlp: nn.Module, drop_path_rate: float,
                 generator: Optional[torch.Generator]) -> Tensor:
    """The blocks' MLP half, `x + drop_path(mlp(norm(x)))`: with a drop-path
    draw (a generator and a nonzero rate) as those ops; without one (serving,
    evaluation, the trainer's deterministic forward) `ops/mlp_block.py:
    mlp_block`, the hand-written kernel in bf16 serving and the same ops on
    the CPU, in f32, under autograd and for blocks wider than the kernel."""
    if generator is not None and drop_path_rate != 0.0:
        return x + drop_path(mlp(norm(x)), drop_path_rate, generator)
    return mlp_block(x, norm, mlp)


def checkpoint_block(block: nn.Module, use_checkpoint: bool, x: Tensor, *args,
                     generator=None) -> Tensor:
    """`block(x, *args, generator)`, its activations recomputed in the
    backward when `use_checkpoint` (`torch.utils.checkpoint`, the JAX
    package's `nn.remat`). Drop path draws from an explicit generator,
    which a recompute would draw from again: the two are not combined."""
    if use_checkpoint:
        if generator is not None:
            raise ValueError("drop path (a generator) under activation checkpointing "
                             "would draw again in the recompute")
        return _checkpointed(block, x, *args)
    return block(x, *args, generator=generator)


def attention_core(q: Tensor, k: Tensor, v: Tensor, scale: float,
                   bias: Optional[Tensor], mask: Optional[Tensor]) -> Tensor:
    """softmax(q * scale @ k^T + bias [+ mask]) @ v over (B_, nh, N, d),
    bias (nh, N, M), mask (nW, N, M): `ops/window_attention.py:
    window_attention`, the hand-written kernel in bf16 serving and the plain
    composition on the CPU, in f32 and under autograd (module docstring)."""
    return window_attention(q, k, v, scale, bias, mask)


# --------------------------------------------------------------------------- #
# Core modules
# --------------------------------------------------------------------------- #

class Mlp(nn.Module):
    """2-layer MLP with exact GELU."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = dense_torch_init(in_features, hidden_features)
        self.fc2 = dense_torch_init(hidden_features, out_features)

    def forward(self, x: Tensor) -> Tensor:
        return linear(self.fc2, F.gelu(linear(self.fc1, x)))  # exact (erf) GELU


class WindowAttention(nn.Module):
    """W-MSA with relative position bias on (B*nW, N, C) windows, with an
    optional additive mask (nW, N, N) per image's window group. HAT's
    `HATWindowAttention` is the same module."""

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size[0] - 1) * (2 * window_size[1] - 1), num_heads))
        self.register_buffer(
            "relative_position_index",
            index_buffer(relative_position_index(*window_size)), persistent=False)
        self.qkv = dense_torch_init(dim, 3 * dim, qkv_bias)
        self.proj = dense_torch_init(dim, dim)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        return self.project(self.attend(linear(self.qkv, x), mask))

    def attend(self, qkv: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """The attention of the windows' (B*nW, N, 3C) qkv rows, (B*nW, nh,
        N, d), as `forward` computes it after its qkv projection: the Swin
        block and HAB hand over rows `ops/window_qkv.py: window_qkv`
        computed, and `project` the result."""
        b_, n, c3 = qkv.shape
        c, nh = c3 // 3, self.num_heads
        qkv = qkv.reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        table = self.relative_position_bias_table.to(qkv.dtype)
        bias = table[self.relative_position_index.view(-1)].view(n, n, nh).permute(2, 0, 1)
        return attention_core(qkv[0], qkv[1], qkv[2], self.scale, bias, mask)

    def project(self, out: Tensor) -> Tensor:
        """proj of `attend`'s (B*nW, nh, N, d) heads: (B*nW, N, C)."""
        b_, nh, n, d = out.shape
        return linear(self.proj, out.transpose(1, 2).reshape(b_, n, nh * d))


class SwinTransformerBlock(nn.Module):
    """Swin block on tokens (B, L, C) of spatial size `x_size`: (S)W-MSA +
    MLP with residuals. The shift mask is made for `x_size`."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        super().__init__()
        self.ws, self.shift = effective_window(input_resolution, window_size, shift_size)
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, (self.ws, self.ws), num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        h, w = x_size
        b, l, c = x.shape
        ws, shift = self.ws, self.shift
        with annotate("zoo.qkv"):
            qkv = window_qkv(x, x_size, ws, shift, self.norm1, self.attn.qkv)
        with annotate("zoo.attention"):
            attn = self.attn.attend(qkv, shift_mask(h, w, ws, shift, x.device))
        with annotate("zoo.proj"):
            attn = window_reverse(self.attn.project(attn).reshape(-1, ws, ws, c), ws, h, w)
            if shift > 0:
                attn = torch.roll(attn, (shift, shift), dims=(1, 2))
            x = x + drop_path(attn.reshape(b, l, c), self.drop_path_rate, generator)
        with annotate("zoo.mlp"):
            return mlp_residual(x, self.norm2, self.mlp, self.drop_path_rate, generator)


class BasicLayer(nn.Module):
    """`depth` Swin blocks, shifts alternating 0 / window // 2, each
    checkpointed when `use_checkpoint`."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rates: Sequence[float] = (),
                 use_checkpoint: bool = False):
        super().__init__()
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        for i in range(depth):
            setattr(self, f"blocks_{i}", SwinTransformerBlock(
                dim, input_resolution, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                drop_path_rates[i] if i < len(drop_path_rates) else 0.0))

    def forward(self, x: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        for i in range(self.depth):
            x = checkpoint_block(getattr(self, f"blocks_{i}"), self.use_checkpoint, x, x_size,
                                 generator=generator)
        return x


class UpsampleStack(nn.Module):
    """conv(nf -> 4nf) + PixelShuffle(2) per power of two (or one 3x)."""

    def __init__(self, scale: int, num_feat: int):
        super().__init__()
        if (scale & (scale - 1)) == 0:
            self.steps = [(f"conv_{i}", 2) for i in range(int(math.log2(scale)))]
            for name, _ in self.steps:
                setattr(self, name, conv2d_torch(4 * num_feat, num_feat))
        elif scale == 3:
            self.steps = [("conv_0", 3)]
            self.conv_0 = conv2d_torch(9 * num_feat, num_feat)
        else:
            raise ValueError(f"scale {scale} not supported (2^n or 3)")

    def forward(self, x: Tensor) -> Tensor:
        for name, r in self.steps:
            x = pixel_shuffle(conv(getattr(self, name), x), r)
        return x


class UpsampleOneStep(nn.Module):
    """Single conv + PixelShuffle(scale)."""

    def __init__(self, scale: int, num_feat: int, num_out_ch: int):
        super().__init__()
        self.scale = scale
        self.conv = conv2d_torch(scale ** 2 * num_out_ch, num_feat)

    def forward(self, x: Tensor) -> Tensor:
        return pixel_shuffle(conv(self.conv, x), self.scale)


def to_tokens(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, L, C)."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def to_image(x: Tensor, x_size: Tuple[int, int]) -> Tensor:
    """(B, L, C) -> (B, H, W, C)."""
    return x.reshape(x.shape[0], x_size[0], x_size[1], x.shape[-1])
