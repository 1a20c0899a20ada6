"""HAT (Hybrid Attention Transformer) in PyTorch, NHWC.

The port of the JAX package's `models/hat.py`:

* CAB: conv -> GELU -> conv -> RCAN channel attention (global average
  pool, 1x1 squeeze / excite, sigmoid).
* HAB: window attention beside a CAB branch scaled by `conv_scale` (0.01),
  then the MLP. Its attention is `swin_common.WindowAttention` (JAX's
  `HATWindowAttention` has the same parameters and math). It keeps its own
  `norm1`, whose image the CAB reads too, and hands that image to
  `ops/window_qkv.py: window_qkv` with no norm: the roll, the partition,
  the qkv Dense and its bias, on the kernel in bf16 serving; the rows go to
  `WindowAttention.attend`.
* OCAB: overlapping cross-attention. Queries come from non-overlapping
  `ws` windows, keys and values from `ws + overlap` windows, which
  `unfold_overlap_windows` cuts with `F.unfold` on the NCHW view,
  rearranged to JAX's (B*nW, owin^2, C) order: torch's unfold layout,
  (C, kh, kw) patches in row-major window order.
* RHAG: `depth` HABs + one OCAB + residual conv; `use_checkpoint`
  checkpoints each HAB, as the JAX package remats them.

Tracing: each HAB, CAB and OCAB forward is a span (`zoo.hab`, `zoo.cab`,
`zoo.ocab`; `utils/profiling.py: annotate`); inside `zoo.hab` the block's
four stages are spans as in `swin_common.SwinTransformerBlock` (`zoo.qkv`
with HAB's own `norm1`, `zoo.attention`, `zoo.proj` with the three-term
residual, `zoo.mlp`), the CAB beside them between the attention and proj.
Each HAB, CAB and OCAB forward counts itself in a class attribute,
process-wide as `ops/dense_block.py: dense_block.launches`: `HAB.calls`,
`CAB.calls`, `OCAB.calls`, and `HAB.masked_attn_calls`, the HABs whose
attention took the shift mask. A HAB checkpointed under autograd
(`use_checkpoint`) runs its forward again in the backward, so there its
counts double; serving runs under `inference_mode`.

The production config (img 416, patch 16 -> input_resolution 26 > window
16) keeps window 16 WITH shifted windows, unlike the other zoo members.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import lrelu, scalar_like
from ..ops.window_qkv import window_qkv
from ..utils.profiling import annotate
from .swin_common import (
    LayerNorm,
    Mlp,
    UpsampleStack,
    WindowAttention,
    attention_core,
    checkpoint_block,
    conv,
    conv2d_torch,
    dense_torch_init,
    drop_path,
    effective_window,
    index_buffer,
    linear,
    mlp_residual,
    reset_zoo_parameters,
    shift_mask,
    to_image,
    to_tokens,
    window_partition,
    window_reverse,
)

Tensor = torch.Tensor


@lru_cache(maxsize=None)
def rpi_oca(window_size: int, overlap_ratio: float) -> np.ndarray:
    """Relative-position index between ws and ws + overlap windows,
    (ws*ws, wse*wse) int32."""
    ws = window_size
    wse = ws + int(overlap_ratio * ws)
    coords_ori = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    coords_ext = np.stack(np.meshgrid(np.arange(wse), np.arange(wse), indexing="ij")).reshape(2, -1)
    rel = coords_ext[:, None, :] - coords_ori[:, :, None]  # 2, ws*ws, wse*wse
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - wse + 1
    rel[:, :, 1] += ws - wse + 1
    rel[:, :, 0] *= ws + wse - 1
    return rel.sum(-1).astype(np.int32)


class ChannelAttention(nn.Module):
    """RCAN channel attention: GAP -> 1x1 squeeze -> ReLU -> 1x1 -> sigmoid."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention_1 = conv2d_torch(num_feat // squeeze_factor, num_feat, kernel=1)
        self.attention_3 = conv2d_torch(num_feat, num_feat // squeeze_factor, kernel=1)

    def forward(self, x: Tensor) -> Tensor:
        y = torch.mean(x, dim=(1, 2), keepdim=True)
        y = conv(self.attention_3, torch.relu(conv(self.attention_1, y)))
        return x * torch.sigmoid(y)


class CAB(nn.Module):
    """conv -> GELU -> conv -> channel attention."""

    calls = 0  # forwards (module docstring)

    def __init__(self, num_feat: int, compress_ratio: int = 3, squeeze_factor: int = 30):
        super().__init__()
        mid = num_feat // compress_ratio
        self.cab_0 = conv2d_torch(mid, num_feat)
        self.cab_2 = conv2d_torch(num_feat, mid)
        self.ca = ChannelAttention(num_feat, squeeze_factor)

    def forward(self, x: Tensor) -> Tensor:
        CAB.calls += 1
        with annotate("zoo.cab"):
            return self.ca(conv(self.cab_2, F.gelu(conv(self.cab_0, x))))


class HAB(nn.Module):
    """Hybrid Attention Block."""

    calls = 0  # forwards (module docstring)
    masked_attn_calls = 0  # forwards whose attention took the shift mask

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.ws, self.shift = effective_window(input_resolution, window_size, shift_size)
        self.conv_scale = conv_scale
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttention(dim, (self.ws, self.ws), num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        HAB.calls += 1
        with annotate("zoo.hab"):
            return self._forward(x, x_size, generator)

    def _forward(self, x: Tensor, x_size: Tuple[int, int], generator) -> Tensor:
        h, w = x_size
        b, l, c = x.shape
        ws, shift = self.ws, self.shift
        with annotate("zoo.qkv"):
            normed = self.norm1(x)
            qkv = window_qkv(normed, x_size, ws, shift, None, self.attn.qkv)
        with annotate("zoo.attention"):
            mask = shift_mask(h, w, ws, shift, x.device)
            if mask is not None:
                HAB.masked_attn_calls += 1
            attn = self.attn.attend(qkv, mask)
        conv_x = self.conv_block(normed.reshape(b, h, w, c)).reshape(b, l, c)
        with annotate("zoo.proj"):
            attn = window_reverse(self.attn.project(attn).reshape(-1, ws, ws, c), ws, h, w)
            if shift > 0:
                attn = torch.roll(attn, (shift, shift), dims=(1, 2))
            x = (x + drop_path(attn.reshape(b, l, c), self.drop_path_rate, generator)
                 + conv_x * scalar_like(conv_x, self.conv_scale))
        with annotate("zoo.mlp"):
            return mlp_residual(x, self.norm2, self.mlp, self.drop_path_rate, generator)


def unfold_overlap_windows(x: Tensor, ws: int, owin: int) -> Tensor:
    """torch `nn.Unfold(kernel=owin, stride=ws, padding=(owin - ws) // 2)`
    of an NHWC tensor: (B, H, W, C) -> (B*nW, owin*owin, C), windows in
    row-major order, each window's pixels row-major."""
    b, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel_size=owin, stride=ws,
                    padding=(owin - ws) // 2)  # (B, C*owin*owin, nW)
    nw = cols.shape[-1]
    return cols.view(b, c, owin * owin, nw).permute(0, 3, 2, 1).reshape(b * nw, owin * owin, c)


class OCAB(nn.Module):
    """Overlapping cross-attention block."""

    calls = 0  # forwards (module docstring)

    def __init__(self, dim: int, input_resolution: Tuple[int, int], window_size: int,
                 overlap_ratio: float, num_heads: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.ws = window_size
        self.owin = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.norm1 = LayerNorm(dim)
        self.qkv = dense_torch_init(dim, 3 * dim, qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window_size + self.owin - 1) ** 2, num_heads))
        self.register_buffer("rpi", index_buffer(rpi_oca(window_size, overlap_ratio)),
                             persistent=False)
        self.proj = dense_torch_init(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: Tensor, x_size: Tuple[int, int]) -> Tensor:
        OCAB.calls += 1
        with annotate("zoo.ocab"):
            return self._forward(x, x_size)

    def _forward(self, x: Tensor, x_size: Tuple[int, int]) -> Tensor:
        h, w = x_size
        b, l, c = x.shape
        ws, owin, nh = self.ws, self.owin, self.num_heads
        d = c // nh
        shortcut = x
        qkv = linear(self.qkv, self.norm1(x).reshape(b, h, w, c))
        q_windows = window_partition(qkv[..., :c], ws).reshape(-1, ws * ws, c)
        kv_windows = unfold_overlap_windows(qkv[..., c:], ws, owin)  # (b*nW, owin^2, 2c)
        b_, nq, _ = q_windows.shape
        n = owin * owin
        qh = q_windows.reshape(b_, nq, nh, d).transpose(1, 2)
        kh = kv_windows[..., :c].reshape(b_, n, nh, d).transpose(1, 2)
        vh = kv_windows[..., c:].reshape(b_, n, nh, d).transpose(1, 2)
        table = self.relative_position_bias_table.to(x.dtype)
        bias = table[self.rpi.view(-1)].view(nq, n, nh).permute(2, 0, 1)
        out = attention_core(qh, kh, vh, self.scale, bias, None)
        out = out.transpose(1, 2).reshape(b_, nq, c)
        out = window_reverse(out.reshape(-1, ws, ws, c), ws, h, w).reshape(b, l, c)
        x = linear(self.proj, out) + shortcut
        return mlp_residual(x, self.norm2, self.mlp, 0.0, None)


class RHAG(nn.Module):
    """Residual Hybrid Attention Group."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float, mlp_ratio: float = 4.0,
                 drop_path_rates: Sequence[float] = (), use_checkpoint: bool = False,
                 resi_connection: str = "1conv"):
        super().__init__()
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        for i in range(depth):
            setattr(self, f"blocks_{i}", HAB(
                dim, input_resolution, num_heads, window_size,
                0 if i % 2 == 0 else window_size // 2, compress_ratio, squeeze_factor,
                conv_scale, mlp_ratio,
                drop_path_rates[i] if i < len(drop_path_rates) else 0.0))
        self.overlap_attn = OCAB(dim, input_resolution, window_size, overlap_ratio, num_heads,
                                 mlp_ratio)
        self.conv = conv2d_torch(dim, dim) if resi_connection == "1conv" else None

    def forward(self, x: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        shortcut = x
        for i in range(self.depth):
            x = checkpoint_block(getattr(self, f"blocks_{i}"), self.use_checkpoint, x, x_size,
                                 generator=generator)
        img = to_image(self.overlap_attn(x, x_size), x_size)
        if self.conv is not None:
            img = conv(self.conv, img)
        return to_tokens(img) + shortcut


class HAT(nn.Module):
    """HAT: conv_first -> RHAG* -> norm -> conv_after_body + skip ->
    pixelshuffle reconstruction."""

    def __init__(self, img_size: int = 64, patch_size: int = 1, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6), window_size: int = 7,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 use_checkpoint: bool = False, upscale: int = 2,
                 upsampler: str = "pixelshuffle", resi_connection: str = "1conv",
                 num_feat: int = 64, scan_layers: bool = False):
        super().__init__()
        if upsampler != "pixelshuffle":
            raise ValueError(f"HAT implements upsampler='pixelshuffle' only, got {upsampler!r}")
        if scan_layers and (len(set(num_heads)) != 1 or len(set(depths)) != 1):
            raise ValueError("scan_layers requires uniform depths/num_heads across groups, "
                             f"got {tuple(depths)}/{tuple(num_heads)}")
        ed = embed_dim
        res = (img_size // patch_size, img_size // patch_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.scan_layers = scan_layers
        self.n_layers = len(depths)
        self.conv_first = conv2d_torch(ed, in_chans)
        self.patch_embed_norm = LayerNorm(ed) if patch_norm else None
        for i, depth in enumerate(depths):
            setattr(self, f"layers_{i}", RHAG(
                ed, res, depth, num_heads[i], window_size, compress_ratio, squeeze_factor,
                conv_scale, overlap_ratio, mlp_ratio,
                dpr[sum(depths[:i]):sum(depths[:i + 1])], use_checkpoint, resi_connection))
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
        feat = conv(self.conv_after_body, to_image(self.norm(t), x_size)) + feat
        feat = lrelu(conv(self.conv_before_upsample, feat), 0.01)
        return conv(self.conv_last, self.upsample(feat))
