"""SwinIR and SwinFIR restoration transformers in PyTorch, NHWC.

The port of the JAX package's `models/swinir.py`. SwinFIR is SwinIR with
the residual conv of each RSTB replaced by an SFB (a spatial ResB beside a
fast-Fourier SpectralTransform, fused by a 1x1 conv).

Structure:
  reflect pad to a multiple of the window -> conv_first 3x3 -> [RSTB]* ->
  LayerNorm -> conv_after_body + skip -> upsampler head ('pixelshuffle' |
  'pixelshuffledirect' | 'nearest+conv' | '' = denoise head with global
  input skip) -> crop to upscale x the input's size

`FourierUnit` computes in f32 whatever its input's dtype, as JAX does. JAX
writes the 2-D transforms as real DFT matmuls; here they are
`torch.fft.rfft2` / `irfft2` (norm='ortho'), the reference's op, held to
the f32 class (`tests/test_torch_swin_common.py`). Its channels interleave as
(c0_re, c0_im, c1_re, ...), torch's packing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import lrelu
from .swin_common import (
    BasicLayer,
    LayerNorm,
    UpsampleOneStep,
    UpsampleStack,
    conv,
    conv2d_torch,
    reset_zoo_parameters,
    to_image,
    to_tokens,
)

Tensor = torch.Tensor


class FourierUnit(nn.Module):
    """rfft2 -> 1x1 conv on the interleaved (re, im) channels -> LeakyReLU
    (0.2) -> irfft2, norm='ortho', all in f32 (the conv's parameters cast
    to f32: a bf16 model's values in f32 arithmetic, as Flax promotes)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.conv_layer = conv2d_torch(2 * embed_dim, 2 * embed_dim, kernel=1)

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, c = x.shape
        xt = x.float().permute(0, 3, 1, 2)  # b, c, h, w
        ff = torch.fft.rfft2(xt, norm="ortho")  # b, c, h, w2
        w2 = ff.shape[-1]
        ffs = torch.stack([ff.real, ff.imag], dim=2).reshape(b, 2 * c, h, w2)
        weight = self.conv_layer.weight.to(x.dtype).float()
        bias = self.conv_layer.bias.to(x.dtype).float()
        ffs = F.conv2d(ffs, weight) + bias[:, None, None]
        ffs = lrelu(ffs, 0.2).reshape(b, c, 2, h, w2)
        out = torch.fft.irfft2(torch.complex(ffs[:, :, 0], ffs[:, :, 1]), s=(h, w),
                               norm="ortho")
        return out.permute(0, 2, 3, 1).to(x.dtype)


class SpectralTransform(nn.Module):
    """1x1 squeeze -> FourierUnit -> 1x1 expand, with the inner skip."""

    def __init__(self, embed_dim: int):
        super().__init__()
        half = embed_dim // 2
        self.conv1 = conv2d_torch(half, embed_dim, kernel=1)
        self.fu = FourierUnit(half)
        self.conv2 = conv2d_torch(embed_dim, half, kernel=1)

    def forward(self, x: Tensor) -> Tensor:
        x = lrelu(conv(self.conv1, x), 0.2)
        return conv(self.conv2, x + self.fu(x))


class ResB(nn.Module):
    """conv -> LeakyReLU(0.2) -> conv residual block."""

    def __init__(self, embed_dim: int, red: int = 1):
        super().__init__()
        mid = embed_dim // red
        self.body_0 = conv2d_torch(mid, embed_dim)
        self.body_2 = conv2d_torch(embed_dim, mid)

    def forward(self, x: Tensor) -> Tensor:
        return conv(self.body_2, lrelu(conv(self.body_0, x), 0.2)) + x


class SFB(nn.Module):
    """Spatial-frequency block: ResB || SpectralTransform -> 1x1 fusion."""

    def __init__(self, embed_dim: int, red: int = 1):
        super().__init__()
        self.S = ResB(embed_dim, red)
        self.F = SpectralTransform(embed_dim)
        self.fusion = conv2d_torch(embed_dim, 2 * embed_dim, kernel=1)

    def forward(self, x: Tensor) -> Tensor:
        return conv(self.fusion, torch.cat([self.S(x), self.F(x)], dim=-1))


class RSTB(nn.Module):
    """Residual Swin Transformer Block: BasicLayer -> residual connection
    ('1conv' | 'SFB' | 'HSFB' | 'identity') + skip."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rates: Sequence[float] = (),
                 use_checkpoint: bool = False, resi_connection: str = "1conv"):
        super().__init__()
        self.residual_group = BasicLayer(dim, input_resolution, depth, num_heads, window_size,
                                         mlp_ratio, qkv_bias, drop_path_rates, use_checkpoint)
        if resi_connection == "1conv":
            self.conv = conv2d_torch(dim, dim)
        elif resi_connection in ("SFB", "HSFB"):
            self.conv = SFB(dim, 1 if resi_connection == "SFB" else 2)
        elif resi_connection == "identity":
            self.conv = None
        else:
            raise ValueError(resi_connection)

    def forward(self, x: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        img = to_image(self.residual_group(x, x_size, generator), x_size)
        if isinstance(self.conv, nn.Conv2d):
            img = conv(self.conv, img)
        elif self.conv is not None:
            img = self.conv(img)
        return to_tokens(img) + x


class SwinIR(nn.Module):
    """SwinIR; `resi_connection='SFB'` makes SwinFIR. `scan_layers` keeps the
    JAX option's name: the stack is the same unrolled one (the math of JAX's
    scanned stack is the unrolled one's), and the Flax layout of its
    parameters is `layers_scan` (`utils/weights.py` converts)."""

    def __init__(self, img_size: int = 64, patch_size: int = 1, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_path_rate: float = 0.1,
                 patch_norm: bool = True, use_checkpoint: bool = False, upscale: int = 2,
                 upsampler: str = "", resi_connection: str = "1conv", num_feat: int = 64,
                 scan_layers: bool = False):
        super().__init__()
        if scan_layers and (len(set(num_heads)) != 1 or len(set(depths)) != 1):
            raise ValueError("scan_layers requires uniform depths/num_heads across layers, "
                             f"got {tuple(depths)}/{tuple(num_heads)}")
        ed, nf = embed_dim, num_feat
        self.window_size = window_size
        self.patches_resolution = (img_size // patch_size, img_size // patch_size)
        self.upscale = upscale
        self.upsampler = upsampler
        self.scan_layers = scan_layers
        self.n_layers = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()

        self.conv_first = conv2d_torch(ed, in_chans)
        self.patch_embed_norm = LayerNorm(ed) if patch_norm else None
        for i, depth in enumerate(depths):
            setattr(self, f"layers_{i}", RSTB(
                ed, self.patches_resolution, depth, num_heads[i], window_size, mlp_ratio,
                qkv_bias, dpr[sum(depths[:i]):sum(depths[:i + 1])], use_checkpoint,
                resi_connection))
        self.norm = LayerNorm(ed)
        self.conv_after_body = conv2d_torch(ed, ed)
        if upsampler == "pixelshuffle":
            self.conv_before_upsample = conv2d_torch(nf, ed)
            self.upsample = UpsampleStack(upscale, nf)
            self.conv_last = conv2d_torch(in_chans, nf)
        elif upsampler == "pixelshuffledirect":
            self.upsample = UpsampleOneStep(upscale, ed, in_chans)
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = conv2d_torch(nf, ed)
            self.conv_up1 = conv2d_torch(nf, nf)
            if upscale == 4:
                self.conv_up2 = conv2d_torch(nf, nf)
            self.conv_hr = conv2d_torch(nf, nf)
            self.conv_last = conv2d_torch(in_chans, nf)
        else:
            self.conv_last = conv2d_torch(in_chans, ed)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_zoo_parameters(self, generator)

    def features(self, feat: Tensor, x_size: Tuple[int, int], generator=None) -> Tensor:
        t = to_tokens(feat)
        if self.patch_embed_norm is not None:
            t = self.patch_embed_norm(t)
        for i in range(self.n_layers):
            t = getattr(self, f"layers_{i}")(t, x_size, generator)
        return to_image(self.norm(t), x_size)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        """NHWC in and out, unclamped; `generator` draws drop path (None:
        the deterministic forward)."""
        h_in, w_in = x.shape[1], x.shape[2]
        # reflect-pad to a multiple of the effective window
        ws = min(self.window_size, min(self.patches_resolution))
        ph, pw = (ws - h_in % ws) % ws, (ws - w_in % ws) % ws
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
        x_size = (h_in + ph, w_in + pw)

        feat = conv(self.conv_first, x)
        feat = conv(self.conv_after_body, self.features(feat, x_size, generator)) + feat
        if self.upsampler == "pixelshuffle":
            feat = lrelu(conv(self.conv_before_upsample, feat), 0.01)
            out = conv(self.conv_last, self.upsample(feat))
        elif self.upsampler == "pixelshuffledirect":
            out = self.upsample(feat)
        elif self.upsampler == "nearest+conv":
            feat = lrelu(conv(self.conv_before_upsample, feat), 0.01)
            feat = lrelu(conv(self.conv_up1, _nearest2(feat)), 0.2)
            if self.upscale == 4:
                feat = lrelu(conv(self.conv_up2, _nearest2(feat)), 0.2)
            out = conv(self.conv_last, lrelu(conv(self.conv_hr, feat), 0.2))
        else:
            out = x + conv(self.conv_last, feat)
        return out[:, : h_in * self.upscale, : w_in * self.upscale, :]


def _nearest2(x: Tensor) -> Tensor:
    """2x nearest upsampling of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def SwinFIR(**kwargs) -> SwinIR:
    """SwinFIR = SwinIR with SFB residual connections."""
    kwargs.setdefault("resi_connection", "SFB")
    return SwinIR(**kwargs)
