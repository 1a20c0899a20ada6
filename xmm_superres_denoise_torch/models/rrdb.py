"""RRDB/ESRGAN-style CNNs (SR generator + denoiser) in PyTorch, NHWC.

The port of the JAX package's `models/rrdb.py`. Public tensors keep
the JAX layouts: activations are NHWC and the dense-block weights HWIO.

* `ResidualDenseBlock5C` calls `ops.dense_block.dense_block`, so a model on
  the card runs its 12 dense blocks (4 RRDB x 3) on the hand-written kernel
  and a model on the CPU runs the plain version. Its five convs hold HWIO
  weights, converted once at load; the block keeps them packed for the
  kernel (`packed`) and packs again only when a parameter changed. When a
  gradient is needed it passes the raw parameters instead, and on the card
  the block runs as one autograd node (`dense_block`'s `_DenseBlockFn`).
* The five convs outside the trunk (conv_first, trunk_conv, upconv, HRconv,
  conv_last) hold `nn.Conv2d` (OIHW) weights, applied to the NCHW view of
  the NHWC activations (channels_last memory), so no layout copy is made;
  the bias is added after the convolution, as Flax's `nn.Conv` does, so a
  bf16 result is rounded where JAX rounds it.
* Initializers follow torch Conv2d defaults (U(+-1/sqrt(fan_in)), fan_in =
  in_ch*9) and the positive-bias init of `conv_last`, whose bound uses
  in_channels only.

Architecture:
  dense block: 5 convs with LeakyReLU(0.2), dense concats, out*0.2 + x
  RRDB: 3 dense blocks, out*0.2 + x
  trunk: conv_first -> N x RRDB -> trunk_conv, skip add
  SR head: [conv(nf->4nf) -> LeakyReLU(0.01) -> PixelShuffle(2)] x num_upsample
           -> HRconv -> LeakyReLU(0.2) -> conv_last -> clamp
           (the upsampling LeakyReLU uses torch's default slope 0.01)
  DN head: conv_last + input skip -> clamp
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dense_block import PackedBlock, dense_block, grad_needed, pack_weights
from ..ops.precision import lrelu, scalar_like

Tensor = torch.Tensor


def pixel_shuffle(x: Tensor, r: int = 2) -> Tensor:
    """torch-channel-order PixelShuffle for NHWC tensors.

    out[n, h*r+i, w*r+j, c] = in[n, h, w, c*r*r + i*r + j]
    """
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # n, h, i, w, j, c
    return x.reshape(n, h * r, w * r, c)


def pixel_unshuffle(x: Tensor, r: int = 2) -> Tensor:
    """Inverse of :func:`pixel_shuffle`: (N, H, W, C) -> (N, H/r, W/r, C*r*r),
    out[n, h, w, c*r*r + i*r + j] = in[n, h*r+i, w*r+j, c]."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # n, h, w, c, i, j
    return x.reshape(n, h, w, c * r * r)


def conv3x3_nhwc(x: Tensor, w_oihw: Tensor, b: Tensor) -> Tensor:
    """SAME 3x3 convolution of an NHWC tensor with OIHW weights, through the
    NCHW view (cuDNN on the card), then the bias: `conv(x, w) + b` as the
    JAX package writes it, so a bf16 result is rounded where JAX rounds it
    (after the convolution and again after the bias add)."""
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1).permute(0, 2, 3, 1) + b


def conv_nhwc(conv: nn.Conv2d, x: Tensor) -> Tensor:
    """Apply a 3x3 SAME `nn.Conv2d` to an NHWC tensor, bias after the
    convolution (`conv3x3_nhwc`)."""
    return conv3x3_nhwc(x, conv.weight, conv.bias)


def conv3x3(in_channels: int, out_channels: int) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, 3, padding=1)


def _uniform_(t: Tensor, lo: float, hi: float, generator) -> None:
    with torch.no_grad():
        t.uniform_(lo, hi, generator=generator)


def torch_conv_init_(weight: Tensor, bias: Tensor, in_channels: int, generator=None):
    """torch Conv2d default init: weight and bias ~ U(+-1/sqrt(in_ch * 9))."""
    bound = 1.0 / math.sqrt(in_channels * 9)
    _uniform_(weight, -bound, bound, generator)
    _uniform_(bias, -bound, bound, generator)


def positive_bias_init_(
    weight: Tensor, bias: Tensor, in_channels: int, offset_std: float = 0.01,
    generator=None,
):
    """conv_last init: U(-stdv, stdv + offset*stdv), stdv = 1/sqrt(in_ch)."""
    stdv = 1.0 / math.sqrt(in_channels)
    _uniform_(weight, -stdv, stdv + offset_std * stdv, generator)
    _uniform_(bias, -stdv, stdv + offset_std * stdv, generator)


class DenseConv(nn.Module):
    """Weights of one dense-block conv in the kernel's layout: HWIO
    (3, 3, in, out), contiguous. The block applies them; this holds them."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 3, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))
        torch_conv_init_(self.weight, self.bias, in_channels)


def _pack_key(p: Tensor):
    """What identifies a parameter's values for `ResidualDenseBlock5C.packed`,
    or None for an inference tensor, which has no version counter."""
    try:
        version = p._version
    except RuntimeError:
        return None
    return version, p.data_ptr(), p.dtype, p.device


class ResidualDenseBlock5C(nn.Module):
    """5-conv dense block with 0.2-scaled residual, on `dense_block`."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        if nf != gc:
            raise ValueError(f"the dense-block kernel needs nf == gc, got {nf}, {gc}")
        for j in range(1, 6):
            setattr(self, f"conv{j}", DenseConv(nf + (j - 1) * gc, nf if j == 5 else gc))
        self._pack: Optional[PackedBlock] = None
        self._pack_key = None

    def flat_params(self):
        """(w1, b1, ..., w5, b5) in `dense_block`'s argument order."""
        out = []
        for j in range(1, 6):
            conv = getattr(self, f"conv{j}")
            out += [conv.weight, conv.bias]
        return out

    def packed(self) -> PackedBlock:
        """The parameters packed for the kernel in their own dtype, made at
        the first call and again only after a parameter's version (an
        in-place change such as `load_state_dict`), storage, dtype or device
        changed. Parameters made inside `torch.inference_mode` keep no
        version counter, so an in-place change cannot be seen: they are
        packed on every call."""
        params = self.flat_params()
        key = tuple(_pack_key(p) for p in params)
        if None in key or key != self._pack_key:
            with torch.no_grad():
                self._pack = pack_weights(params[0::2], params[1::2], params[0].dtype)
            self._pack_key = key
        return self._pack

    def forward(self, x: Tensor) -> Tensor:
        """The block on `dense_block`: with the raw parameters when autograd
        must see them (on the card, `dense_block`'s autograd route, K2
        forward and a recomputed backward), with the cached pack otherwise."""
        x = x.contiguous()
        params = self.flat_params()
        if grad_needed(x, *params):
            return dense_block(x, *params)
        return dense_block(x, self.packed())


class RRDB(nn.Module):
    """Residual-in-residual dense block."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc)
        self.RDB2 = ResidualDenseBlock5C(nf, gc)
        self.RDB3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x: Tensor) -> Tensor:
        out = self.RDB3(self.RDB2(self.RDB1(x)))
        return out * scalar_like(out, 0.2) + x


class RRDBTrunk(nn.Module):
    """conv_first -> N x RRDB -> trunk_conv with long skip."""

    def __init__(self, in_channels: int, num_filters: int, num_res_blocks: int):
        super().__init__()
        nf = num_filters
        self.conv_first = conv3x3(in_channels, nf)
        for i in range(num_res_blocks):
            setattr(self, f"rrdb_{i}", RRDB(nf, nf))
        self.num_res_blocks = num_res_blocks
        self.trunk_conv = conv3x3(nf, nf)

    def forward(self, x: Tensor) -> Tensor:
        fea = conv_nhwc(self.conv_first, x)
        t = fea
        for i in range(self.num_res_blocks):
            t = getattr(self, f"rrdb_{i}")(t)
        return fea + conv_nhwc(self.trunk_conv, t)


class _Generator(nn.Module):
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every weight with the torch-default inits from `generator`."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DenseConv)):
                in_ch = m.weight.shape[1] if isinstance(m, nn.Conv2d) else m.weight.shape[2]
                torch_conv_init_(m.weight, m.bias, in_ch, generator)
        positive_bias_init_(
            self.conv_last.weight, self.conv_last.bias, self.num_filters,
            generator=generator,
        )


class GeneratorRRDB_SR(_Generator):
    """2x-per-stage super-resolution generator; NHWC in, NHWC out."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        num_filters: int = 32,
        num_res_blocks: int = 4,
        num_upsample: int = 1,
    ):
        super().__init__()
        nf = num_filters
        self.num_filters = nf
        self.num_upsample = num_upsample
        self.trunk = RRDBTrunk(in_channels, nf, num_res_blocks)
        for i in range(num_upsample):
            setattr(self, f"upconv_{i}", conv3x3(nf, nf * 4))
        self.HRconv = conv3x3(nf, nf)
        self.conv_last = conv3x3(nf, out_channels)
        positive_bias_init_(self.conv_last.weight, self.conv_last.bias, nf)

    def forward(self, x: Tensor) -> Tensor:
        fea = self.trunk(x)
        for i in range(self.num_upsample):
            fea = conv_nhwc(getattr(self, f"upconv_{i}"), fea)
            fea = pixel_shuffle(lrelu(fea, 0.01), 2)
        fea = lrelu(conv_nhwc(self.HRconv, fea), 0.2)
        out = conv_nhwc(self.conv_last, fea)
        return torch.clamp(out, 0.0, 1.0)


class GeneratorRRDB_DN(_Generator):
    """Same-resolution denoiser with input skip; NHWC in, NHWC out."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        num_filters: int = 32,
        num_res_blocks: int = 4,
    ):
        super().__init__()
        nf = num_filters
        self.num_filters = nf
        self.trunk = RRDBTrunk(in_channels, nf, num_res_blocks)
        self.conv_last = conv3x3(nf, out_channels)
        positive_bias_init_(self.conv_last.weight, self.conv_last.bias, nf)

    def forward(self, x: Tensor) -> Tensor:
        out = conv_nhwc(self.conv_last, self.trunk(x)) + x
        return torch.clamp(out, 0.0, 1.0)
