"""Restormer (MDTA + GDFN U-Net) in PyTorch, NHWC.

The port of the JAX package's `models/restormer.py`:

* MDTA: transposed (channel) attention. q, k, v from a 1x1 conv and a
  3x3 depthwise conv, q and k L2-normalized over the pixels; the attention
  is (d x d) per head with a learned per-head temperature; its logits are
  f32 from operands in the input's dtype, as the zoo's window attention.
  That side, from qkv to the softmaxed attention, is `ops/mdta_gram.py:
  mdta_gram`: hand-written kernels in bf16 serving, the PyTorch ops
  (`mdta_attention_plain`) otherwise.
* GDFN: gated depthwise feed-forward.
* `ChannelLayerNorm`: per-pixel LayerNorm over the channels ('WithBias',
  eps 1e-5 inside the sqrt, biased variance), computed in the input's
  dtype like JAX's (no f32 promotion, unlike Flax's `LayerNorm`).
* A 4-level U-Net with pixel-(un)shuffle resizing (torch channel order,
  `models/rrdb.py`), skip concats, channel reducers, refinement and a
  global input residual.

Tracing: each MDTA and GDFN forward is a span (`zoo.mdta`, `zoo.gdfn`;
`utils/profiling.py: annotate`) and counts itself in a class attribute,
process-wide as `models/hat.py: HAB.calls`: `MDTA.calls`, `GDFN.calls`,
one each per `RestormerBlock` forward. Each `ChannelLayerNorm` forward,
its statistics and its passes, is a span too (`zoo.channel_norm`), two a
block beside MDTA's and GDFN's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mdta_gram import heads_first, mdta_gram
from ..ops.precision import scalar_like
from ..utils.profiling import annotate
from .rrdb import pixel_shuffle, pixel_unshuffle
from .swin_common import conv, conv2d_torch, reset_zoo_parameters

Tensor = torch.Tensor


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis; `with_bias` selects 'WithBias'
    (mean-subtracting, with a bias) over 'BiasFree'."""

    def __init__(self, dim: int, with_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if with_bias else None

    def forward(self, x: Tensor) -> Tensor:
        with annotate("zoo.channel_norm"):
            weight = self.weight.to(x.dtype)
            eps = scalar_like(x, 1e-5)
            var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
            if self.bias is None:
                return x / torch.sqrt(var + eps) * weight
            mu = torch.mean(x, dim=-1, keepdim=True)
            return (x - mu) / torch.sqrt(var + eps) * weight + self.bias.to(x.dtype)


def depthwise_conv3x3(features: int, use_bias: bool) -> nn.Conv2d:
    """3x3 depthwise conv (torch's default init: fan_in = 9)."""
    return conv2d_torch(features, features, 3, use_bias, groups=features)


class MDTA(nn.Module):
    """Multi-DConv-head transposed attention."""

    calls = 0  # forwards (module docstring)

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = conv2d_torch(3 * dim, dim, 1, use_bias)
        self.qkv_dwconv = depthwise_conv3x3(3 * dim, use_bias)
        self.project_out = conv2d_torch(dim, dim, 1, use_bias)

    def forward(self, x: Tensor) -> Tensor:
        MDTA.calls += 1
        with annotate("zoo.mdta"):
            return self._forward(x)

    def _forward(self, x: Tensor) -> Tensor:
        b, h, w, c = x.shape
        qkv = conv(self.qkv_dwconv, conv(self.qkv, x))
        attn = mdta_gram(qkv, self.num_heads, self.temperature)
        v = heads_first(qkv[..., 2 * c:], self.num_heads)
        out = torch.matmul(attn, v).permute(0, 3, 1, 2).reshape(b, h, w, c)
        return conv(self.project_out, out)


class GDFN(nn.Module):
    """Gated-DConv feed-forward."""

    calls = 0  # forwards (module docstring)

    def __init__(self, dim: int, expansion: float = 2.66, use_bias: bool = False):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = conv2d_torch(2 * hidden, dim, 1, use_bias)
        self.dwconv = depthwise_conv3x3(2 * hidden, use_bias)
        self.project_out = conv2d_torch(dim, hidden, 1, use_bias)

    def forward(self, x: Tensor) -> Tensor:
        GDFN.calls += 1
        with annotate("zoo.gdfn"):
            x1, x2 = conv(self.dwconv, conv(self.project_in, x)).chunk(2, dim=-1)
            return conv(self.project_out, F.gelu(x1) * x2)


class RestormerBlock(nn.Module):
    """LN -> MDTA residual, LN -> GDFN residual."""

    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 use_bias: bool = False):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = MDTA(dim, num_heads, use_bias)
        self.norm2 = ChannelLayerNorm(dim)
        self.ffn = GDFN(dim, expansion, use_bias)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class Downsample(nn.Module):
    """conv(c -> c/2) + PixelUnshuffle(2): halves the resolution, doubles
    the channels."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = conv2d_torch(n_feat // 2, n_feat, use_bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return pixel_unshuffle(conv(self.body, x), 2)


class Upsample(nn.Module):
    """conv(c -> 2c) + PixelShuffle(2): doubles the resolution, halves the
    channels."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = conv2d_torch(n_feat * 2, n_feat, use_bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return pixel_shuffle(conv(self.body, x), 2)


class Restormer(nn.Module):
    """4-level encoder/decoder with refinement and a global input skip."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                 use_bias: bool = False):
        super().__init__()
        d = dim
        self.stages = {}  # stage name -> its number of blocks

        def blocks(n: int, width: int, nh: int, name: str) -> None:
            for i in range(n):
                setattr(self, f"{name}_{i}",
                        RestormerBlock(width, nh, ffn_expansion_factor, use_bias))
            self.stages[name] = n

        self.patch_embed = conv2d_torch(d, inp_channels, use_bias=False)
        blocks(num_blocks[0], d, heads[0], "encoder_level1")
        self.down1_2 = Downsample(d)
        blocks(num_blocks[1], d * 2, heads[1], "encoder_level2")
        self.down2_3 = Downsample(d * 2)
        blocks(num_blocks[2], d * 4, heads[2], "encoder_level3")
        self.down3_4 = Downsample(d * 4)
        blocks(num_blocks[3], d * 8, heads[3], "latent")
        self.up4_3 = Upsample(d * 8)
        self.reduce_chan_level3 = conv2d_torch(d * 4, d * 8, 1, use_bias)
        blocks(num_blocks[2], d * 4, heads[2], "decoder_level3")
        self.up3_2 = Upsample(d * 4)
        self.reduce_chan_level2 = conv2d_torch(d * 2, d * 4, 1, use_bias)
        blocks(num_blocks[1], d * 2, heads[1], "decoder_level2")
        self.up2_1 = Upsample(d * 2)
        blocks(num_blocks[0], d * 2, heads[0], "decoder_level1")
        blocks(num_refinement_blocks, d * 2, heads[0], "refinement")
        self.output = conv2d_torch(out_channels, d * 2, use_bias=use_bias)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_zoo_parameters(self, generator)

    def _run(self, name: str, t: Tensor) -> Tensor:
        for i in range(self.stages[name]):
            t = getattr(self, f"{name}_{i}")(t)
        return t

    def forward(self, x: Tensor) -> Tensor:
        """NHWC in and out, unclamped."""
        enc1 = self._run("encoder_level1", conv(self.patch_embed, x))
        enc2 = self._run("encoder_level2", self.down1_2(enc1))
        enc3 = self._run("encoder_level3", self.down2_3(enc2))
        latent = self._run("latent", self.down3_4(enc3))
        dec3 = torch.cat([self.up4_3(latent), enc3], dim=-1)
        dec3 = self._run("decoder_level3", conv(self.reduce_chan_level3, dec3))
        dec2 = torch.cat([self.up3_2(dec3), enc2], dim=-1)
        dec2 = self._run("decoder_level2", conv(self.reduce_chan_level2, dec2))
        dec1 = self._run("decoder_level1", torch.cat([self.up2_1(dec2), enc1], dim=-1))
        out = self._run("refinement", dec1)
        return conv(self.output, out) + x
