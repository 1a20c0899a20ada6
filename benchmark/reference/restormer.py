"""Frozen plain reference of Restormer de-noising serving (Zamir et al.
2022, "Restormer: Efficient Transformer for High-Resolution Image
Restoration", arXiv:2111.09881), with the pipeline's pre- and
post-processing.

Plain `torch`, float32 with TF32 off, NCHW as the paper's code, written
from the paper and the configuration; it imports nothing of the port.
Parameter names and shapes are the serving state_dict's, so that the
benchmark hands one seeded dict to the program and to this reference.

    patch_embed 3x3 (in -> dim) -> encoder levels 1-3 [blocks, then
    Downsample: 3x3 conv c -> c/2, pixel-unshuffle 2] -> latent blocks ->
    decoder levels 3, 2 [Upsample: 3x3 conv c -> 2c, pixel-shuffle 2;
    concat the encoder's level; 1x1 reduce_chan; blocks] -> decoder level 1
    [Upsample; concat; blocks at 2 * dim] -> refinement blocks -> output
    3x3 (2 * dim -> out) + the input

Block: x + MDTA(LN1(x)), then x + GDFN(LN2(x)).
    LN: over the channels of each pixel, (x - mean) / sqrt(var + 1e-5) *
    weight + bias, the variance biased ('WithBias').
    MDTA: q, k, v = 3x3 depthwise(1x1 conv c -> 3c), split; per head of d
    = c / heads channels, q and k L2-normalised over the H * W pixels (eps
    1e-12), A = softmax over keys of (q k^T) * temperature, a (d x d) Gram
    contracted over every pixel; out = A v; 1x1 project_out.
    GDFN: x1, x2 = 3x3 depthwise(1x1 conv c -> 2h), h = int(c * 2.66),
    split; 1x1 project_out(GELU(x1) * x2), GELU exact.
Pixel (un)shuffle in torch's channel order, written out here: the
unshuffled channel c * 4 + i * 2 + j holds pixel (2y + i, 2x + j) of
channel c.

Departures from the paper, each the configuration's: one input and one
output channel; 'WithBias' LayerNorm only; seeded weights (`make_params`),
the temperatures drawn log-normal where a fresh model holds ones, so that
a temperature left out shows.

`quant`, when given, is applied to both operands of every convolution,
depthwise ones included, and of both of MDTA's products (the control's
lower precision); LayerNorm, the L2 norms, softmax, GELU and the gate stay
float32. `serve` runs one image at a time: GDFN's 510 channels at 416^2
are 353 MB an image in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .rrdb import finish, prepare
from .swinir import Quant, fp8  # noqa: F401

Tensor = torch.Tensor


def stages(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """(name, blocks, channels, heads) of every stage of blocks, in order."""
    d, nb, hd = cfg["dim"], cfg["num_blocks"], cfg["heads"]
    return [("encoder_level1", nb[0], d, hd[0]), ("encoder_level2", nb[1], 2 * d, hd[1]),
            ("encoder_level3", nb[2], 4 * d, hd[2]), ("latent", nb[3], 8 * d, hd[3]),
            ("decoder_level3", nb[2], 4 * d, hd[2]), ("decoder_level2", nb[1], 2 * d, hd[1]),
            ("decoder_level1", nb[0], 2 * d, hd[0]),
            ("refinement", cfg["num_refinement_blocks"], 2 * d, hd[0])]


def param_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is 'conv' (uniform
    +-1/sqrt(fan_in)), 'normal' (std 0.02), 'scale' (1 + normal 0.02) or
    'temperature' (exp of normal 0.5)."""
    d, cin, cout, bias = cfg["dim"], cfg["in_channels"], cfg["out_channels"], cfg["bias"]

    def conv(p, n_out, n_in, k, with_bias=bias):
        out = [(f"{p}.weight", (n_out, n_in, k, k), "conv")]
        return out + ([(f"{p}.bias", (n_out,), "conv")] if with_bias else [])

    def norm(p, c):
        return [(f"{p}.weight", (c,), "scale"), (f"{p}.bias", (c,), "normal")]

    def block(p, c, nh):
        hidden = int(c * cfg["ffn_expansion_factor"])
        return (norm(f"{p}.norm1", c) + [(f"{p}.attn.temperature", (nh, 1, 1), "temperature")]
                + conv(f"{p}.attn.qkv", 3 * c, c, 1) + conv(f"{p}.attn.qkv_dwconv", 3 * c, 1, 3)
                + conv(f"{p}.attn.project_out", c, c, 1) + norm(f"{p}.norm2", c)
                + conv(f"{p}.ffn.project_in", 2 * hidden, c, 1)
                + conv(f"{p}.ffn.dwconv", 2 * hidden, 1, 3)
                + conv(f"{p}.ffn.project_out", c, hidden, 1))

    def blocks(i):
        name, n, c, nh = stages(cfg)[i]
        return [s for j in range(n) for s in block(f"{name}_{j}", c, nh)]

    out = conv("patch_embed", d, cin, 3, False) + blocks(0)
    out += conv("down1_2.body", d // 2, d, 3, False) + blocks(1)
    out += conv("down2_3.body", d, 2 * d, 3, False) + blocks(2)
    out += conv("down3_4.body", 2 * d, 4 * d, 3, False) + blocks(3)
    out += conv("up4_3.body", 16 * d, 8 * d, 3, False) + conv("reduce_chan_level3", 4 * d, 8 * d, 1)
    out += blocks(4)
    out += conv("up3_2.body", 8 * d, 4 * d, 3, False) + conv("reduce_chan_level2", 2 * d, 4 * d, 1)
    out += blocks(5)
    out += conv("up2_1.body", 4 * d, 2 * d, 3, False) + blocks(6) + blocks(7)
    return out + conv("output", cout, 2 * d, 3)


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Tensor]:
    """Seeded weights made on `device` in two draws (one normal, one
    uniform over every parameter), scaled per init and cast to `dtype`."""
    spec = param_shapes(cfg)
    sizes = [math.prod(s) for _, s, _ in spec]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, init), n in zip(spec, sizes):
        if init == "conv":
            weight = shape if len(shape) == 4 else out[name[: -len("bias")] + "weight"].shape
            v = uniform[at : at + n] / math.sqrt(math.prod(weight[1:]))
        elif init == "scale":
            v = 1.0 + 0.02 * normal[at : at + n]
        elif init == "temperature":
            v = torch.exp(0.5 * normal[at : at + n])
        else:
            v = 0.02 * normal[at : at + n]
        out[name] = v.reshape(shape).to(dtype)
        at += n
    return out


def _conv(w, name: str, x: Tensor, q: Quant, groups: int = 1) -> Tensor:
    """SAME convolution of NCHW `x` (depthwise at groups = channels), its
    bias (if any) added after."""
    k = w[f"{name}.weight"]
    if q is not None:
        k, x = q(k), q(x)
    y = F.conv2d(x, k, padding=k.shape[-1] // 2, groups=groups)
    b = w.get(f"{name}.bias")
    return y if b is None else y + b[:, None, None]


def _mm(a: Tensor, b: Tensor, q: Quant) -> Tensor:
    if q is not None:
        a, b = q(a), q(b)
    return torch.matmul(a, b)


def _ln(w, name: str, x: Tensor) -> Tensor:
    mu = x.mean(1, keepdim=True)
    var = ((x - mu) ** 2).mean(1, keepdim=True)
    return ((x - mu) / torch.sqrt(var + 1e-5) * w[f"{name}.weight"][:, None, None]
            + w[f"{name}.bias"][:, None, None])


def pixel_unshuffle(x: Tensor) -> Tensor:
    """(B, C, 2H, 2W) -> (B, 4C, H, W), channel c * 4 + i * 2 + j."""
    b, c, h2, w2 = x.shape
    x = x.reshape(b, c, h2 // 2, 2, w2 // 2, 2).permute(0, 1, 3, 5, 2, 4)  # b, c, i, j, y, x
    return x.reshape(b, 4 * c, h2 // 2, w2 // 2)


def pixel_shuffle(x: Tensor) -> Tensor:
    """`pixel_unshuffle` undone: (B, 4C, H, W) -> (B, C, 2H, 2W)."""
    b, c4, h, wd = x.shape
    x = x.reshape(b, c4 // 4, 2, 2, h, wd).permute(0, 1, 4, 2, 5, 3)  # b, c, y, i, x, j
    return x.reshape(b, c4 // 4, 2 * h, 2 * wd)


def _l2_normalize(t: Tensor) -> Tensor:
    """Over the last axis (the pixels), eps 1e-12."""
    return F.normalize(t, dim=-1, eps=1e-12)


def _logits(q: Tensor, k: Tensor, temperature: Tensor, quant: Quant) -> Tensor:
    """(B, heads, d, d): the Gram q k^T over the pixels, times the head's
    temperature."""
    return _mm(q, k.transpose(-2, -1), quant) * temperature


def _gate(x1: Tensor, x2: Tensor) -> Tensor:
    return F.gelu(x1) * x2


def _mdta(w, p: str, x: Tensor, heads: int, q: Quant) -> Tensor:
    b, c, h, wd = x.shape
    qkv = _conv(w, f"{p}.qkv_dwconv", _conv(w, f"{p}.qkv", x, q), q, groups=3 * c)
    qh, kh, vh = (t.reshape(b, heads, c // heads, h * wd) for t in qkv.chunk(3, 1))
    a = torch.softmax(_logits(_l2_normalize(qh), _l2_normalize(kh), w[f"{p}.temperature"], q), -1)
    return _conv(w, f"{p}.project_out", _mm(a, vh, q).reshape(b, c, h, wd), q)


def _gdfn(w, p: str, x: Tensor, q: Quant) -> Tensor:
    t = _conv(w, f"{p}.project_in", x, q)
    x1, x2 = _conv(w, f"{p}.dwconv", t, q, groups=t.shape[1]).chunk(2, 1)
    return _conv(w, f"{p}.project_out", _gate(x1, x2), q)


def _stage(w, cfg: dict, i: int, x: Tensor, q: Quant) -> Tensor:
    name, n, _, heads = stages(cfg)[i]
    for j in range(n):
        p = f"{name}_{j}"
        x = x + _mdta(w, f"{p}.attn", _ln(w, f"{p}.norm1", x), heads, q)
        x = x + _gdfn(w, f"{p}.ffn", _ln(w, f"{p}.norm2", x), q)
    return x


def model(w: Dict[str, Tensor], x: Tensor, cfg: dict, q: Quant = None) -> Tensor:
    """(B, in_channels, H, W) float32 normalized input -> raw output of the
    same shape, unclamped; H and W multiples of 8."""
    if x.shape[2] % 8 or x.shape[3] % 8:
        raise ValueError(f"three halvings need sides that are multiples of 8: {tuple(x.shape)}")
    enc1 = _stage(w, cfg, 0, _conv(w, "patch_embed", x, q), q)
    enc2 = _stage(w, cfg, 1, pixel_unshuffle(_conv(w, "down1_2.body", enc1, q)), q)
    enc3 = _stage(w, cfg, 2, pixel_unshuffle(_conv(w, "down2_3.body", enc2, q)), q)
    latent = _stage(w, cfg, 3, pixel_unshuffle(_conv(w, "down3_4.body", enc3, q)), q)
    t = torch.cat([pixel_shuffle(_conv(w, "up4_3.body", latent, q)), enc3], 1)
    t = _stage(w, cfg, 4, _conv(w, "reduce_chan_level3", t, q), q)
    t = torch.cat([pixel_shuffle(_conv(w, "up3_2.body", t, q)), enc2], 1)
    t = _stage(w, cfg, 5, _conv(w, "reduce_chan_level2", t, q), q)
    t = _stage(w, cfg, 6, torch.cat([pixel_shuffle(_conv(w, "up2_1.body", t, q)), enc1], 1), q)
    return _conv(w, "output", _stage(w, cfg, 7, t, q), q) + x


def serve(w: Dict[str, Tensor], rates: Tensor, cfg: dict, dtype=torch.float32,
          q: Quant = None) -> tuple:
    """(B, H, W) rates -> (prediction (B, lr, lr), input half (B, lr, lr)),
    float32: `rrdb.prepare` and `rrdb.finish` around this model, one image
    at a time; `dtype` and `q` are the control's."""
    x, inp = prepare(rates, cfg, dtype)
    y = torch.cat([model(w, x[i : i + 1, None].float(), cfg, q) for i in range(len(x))])
    return finish(y[:, 0], cfg, dtype), inp


def weights(cfg: dict, seed: int, root, device) -> Dict[str, Tensor]:
    """The reference's own float32 copy of the seeded weights."""
    return {k: v.float() for k, v in make_params(cfg, seed, device).items()}
