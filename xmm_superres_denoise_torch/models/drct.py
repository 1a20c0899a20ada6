"""DRCT (Dense-Residual-Connected Transformer) in PyTorch, NHWC.

The port of the JAX package's `models/drct.py`: RDG groups of 5 Swin
blocks with RRDB-style dense connections. Each block's output is
1x1-conv-adjusted to `gc` channels and concatenated; the last adjust maps
back to `dim`, with a 0.2-scaled residual.

* Block head counts follow the reference's formula: block 1 takes
  `num_heads`, blocks 2-5 `num_heads - (channels % num_heads)` unless the
  channels divide evenly.
* Blocks 4 and 5 use mlp_ratio 1.
* A group returns `x5 * 0.2 + x` (the reference returned `x`, making every
  group an identity; the JAX package fixed it and the port keeps the fix).
* `use_checkpoint` checkpoints each Swin block, as the JAX package remats
  them; `scan_layers` is the layout option of `models/swinir.py: SwinIR`.

Tracing: each RDG forward is a span (`zoo.rdg`) and so is each of its five
dense steps, the adjust convolution with its LeakyReLU and concatenation
(`zoo.dense`; `utils/profiling.py: annotate`); each Swin block inside it
opens its four stage spans (`swin_common.SwinTransformerBlock`). The RDG
counts itself in class attributes, process-wide as `models/hat.py:
HAB.calls`: `RDG.calls`, and `RDG.masked_attn_calls`, its Swin blocks whose
attention took the shift mask (blocks 2 and 4 when the window is not
clamped).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.precision import lrelu, scalar_like
from ..utils.profiling import annotate
from .swin_common import (
    LayerNorm,
    SwinTransformerBlock,
    UpsampleStack,
    checkpoint_block,
    conv,
    conv2d_torch,
    reset_zoo_parameters,
    to_image,
    to_tokens,
)

Tensor = torch.Tensor


class RDG(nn.Module):
    """Residual Dense Group of 5 dense-connected Swin blocks."""

    calls = 0  # forwards (module docstring)
    masked_attn_calls = 0  # Swin blocks run whose attention took the shift mask

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int, mlp_ratio: float, gc: int, drop_path_rate: float = 0.0,
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        ws = window_size
        for i in range(1, 6):
            channels = dim + (i - 1) * gc
            heads = (num_heads if i == 1 or channels % num_heads == 0
                     else num_heads - channels % num_heads)
            setattr(self, f"swin{i}", SwinTransformerBlock(
                channels, input_resolution, heads, ws, 0 if i % 2 else ws // 2,
                mlp_ratio if i <= 3 else 1.0, drop_path_rate=drop_path_rate))
            setattr(self, f"adjust{i}", conv2d_torch(dim if i == 5 else gc, channels, kernel=1))

    def forward(self, x: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        RDG.calls += 1
        with annotate("zoo.rdg"):
            return self._forward(x, x_size, generator)

    def _forward(self, x: Tensor, x_size: Tuple[int, int], generator) -> Tensor:
        feats = x
        for i in range(1, 6):
            block = getattr(self, f"swin{i}")
            if block.shift > 0:
                RDG.masked_attn_calls += 1
            t = checkpoint_block(block, self.use_checkpoint, feats, x_size, generator=generator)
            with annotate("zoo.dense"):
                t = conv(getattr(self, f"adjust{i}"), to_image(t, x_size))
                if i < 5:
                    t = to_tokens(lrelu(t, 0.2))
                    # the first concat is (x1, x), later ones append
                    feats = torch.cat([t, feats] if i == 1 else [feats, t], dim=-1)
        x5 = to_tokens(t)
        return x5 * scalar_like(x5, 0.2) + x


class DRCT(nn.Module):
    """conv_first -> RDG* -> norm -> conv_after_body + skip -> pixelshuffle
    reconstruction."""

    def __init__(self, img_size: int = 64, patch_size: int = 1, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6), window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1, patch_norm: bool = True,
                 use_checkpoint: bool = False, upscale: int = 2,
                 upsampler: str = "pixelshuffle", gc: int = 32, num_feat: int = 64,
                 scan_layers: bool = False):
        super().__init__()
        if upsampler != "pixelshuffle":
            raise ValueError(f"DRCT implements upsampler='pixelshuffle' only, got {upsampler!r}")
        if scan_layers and len(set(num_heads)) != 1:
            raise ValueError("scan_layers requires uniform num_heads across groups, "
                             f"got {tuple(num_heads)}")
        ed = embed_dim
        res = (img_size // patch_size, img_size // patch_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.scan_layers = scan_layers
        self.n_layers = len(depths)
        self.conv_first = conv2d_torch(ed, in_chans)
        self.patch_embed_norm = LayerNorm(ed) if patch_norm else None
        for i in range(len(depths)):
            setattr(self, f"layers_{i}", RDG(ed, res, num_heads[i], window_size, mlp_ratio, gc,
                                             dpr[sum(depths[:i])], use_checkpoint))
        self.norm = LayerNorm(ed)
        self.conv_after_body = conv2d_torch(ed, ed)
        self.conv_before_upsample = conv2d_torch(num_feat, ed)
        self.upsample = UpsampleStack(upscale, num_feat)
        self.conv_last = conv2d_torch(in_chans, num_feat)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_zoo_parameters(self, generator)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        """NHWC in and out, unclamped; `generator` draws drop path."""
        x_size = (x.shape[1], x.shape[2])
        feat = conv(self.conv_first, x)
        t = to_tokens(feat)
        if self.patch_embed_norm is not None:
            t = self.patch_embed_norm(t)
        for i in range(self.n_layers):
            t = getattr(self, f"layers_{i}")(t, x_size, generator)
        body = to_image(self.norm(t), x_size)
        feat = conv(self.conv_after_body, body) + feat
        feat = lrelu(conv(self.conv_before_upsample, feat), 0.01)
        return conv(self.conv_last, self.upsample(feat))
