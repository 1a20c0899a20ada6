"""Frozen plain reference of DRCT SR serving (Hsu, Lee and Chou 2024,
"Saving Image Super-resolution away from Information Bottleneck",
arXiv:2404.13925), with the pipeline's pre- and post-processing.

Plain `torch`, float32 with TF32 off, NHWC tokens, written from the paper
and the configuration; it imports nothing of the port. Parameter names
and shapes are the serving state_dict's (Flax names with '.'), so that the
benchmark hands one seeded dict to the program and to this reference.

    conv_first 3x3 -> LayerNorm -> RDG x len(depths) -> LayerNorm ->
    conv_after_body + skip -> conv_before_upsample, LeakyReLU 0.01 ->
    [conv 64 -> 256, pixel shuffle 2] per factor of 2 -> conv_last

RDG (residual dense group), five Swin blocks with dense connections: block
j reads the group input and every earlier block's adjusted output, C_j =
embed + (j - 1) * gc channels; its output goes through a 1x1 `adjust`
convolution to gc channels and LeakyReLU 0.2, and joins the features that
block j + 1 reads; block 5's adjust maps back to embed channels, with no
activation, and the group returns x5 * 0.2 + x.
    Heads: block 1 takes num_heads, blocks 2-5 num_heads - C_j % num_heads
    (embed 180, gc 32, 6 heads: 6, 4, 2, 6, 4 heads of 30, 53, 122, 46, 77
    channels). MLP ratio: the configuration's in blocks 1-3, 1 in 4 and 5.
    Swin block, pre-norm: x + W-MSA(LN1(x)), then x + MLP(LN2(x)) with exact
    GELU; W-MSA over ws x ws windows with the relative-position bias; blocks
    2 and 4 roll the image by -ws // 2 first and back after, and logits
    between pixels of different regions of the rolled image get -100 (the
    shift mask, `hat.shift_mask`).

Window rule (the configuration's): img_size // patch_size must exceed the
window, which then stays ws with shift ws // 2; the image must be whole
windows. At img 416, patch 16, window 16: 26 x 26 windows of 256 pixels.
Clamped or padded windows are refused rather than carried untested.

Departures from the paper, each the configuration's or the port's:
* The features a block reads are ordered (x1, x, x2, x3, x4), where the
  published code concatenates (x, x1, x2, x3, x4): the port's order, which
  the JAX package took from the repository it re-implements. It is a
  permutation of the channels blocks 2-5 read, the same model under a
  permutation of their weights.
* The group returns x5 * 0.2 + x, as the paper does; the repository the
  JAX package re-implements returned x, which made every group an identity,
  and the JAX package and the port fixed it.
* `mlp_ratio` 4 in blocks 1-3, where the paper's SR models use 2 (the run
  config leaves the class default of 4).
* No mean shift: with one input channel the mean is 0 and img_range 1. No
  absolute position embedding and no drop path (serving).
* Seeded weights, conv_last's bias `out_bias` (`make_params`).

`quant`, when given, is applied to both operands of every convolution and
matrix product (the control's lower precision); LayerNorm, softmax and GELU
stay float32. `serve` runs one image at a time, so that the attention
logits of a full-size image (1.1 GB at 6 heads) fit on the card beside the
features.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .hat import _attention, _heads, _image, _merge, _mlp, _pointwise, _windows, shift_mask
from .rrdb import finish, prepare
from .swinir import Quant, _conv, _linear, _ln, _rel_index, fp8  # noqa: F401

Tensor = torch.Tensor


def window(cfg: dict) -> Tuple[int, int]:
    """(window, shift of blocks 2 and 4)."""
    ws = cfg["window_size"]
    if cfg["img_size"] // cfg["patch_size"] <= ws:
        raise ValueError(f"this reference runs unclamped, shifted windows: img_size "
                         f"{cfg['img_size']} // patch_size {cfg['patch_size']} <= window {ws}")
    return ws, ws // 2


def blocks(cfg: dict, num_heads: int) -> List[Tuple[int, int, int, int, int]]:
    """(channels read, heads, MLP hidden, shift, adjust's output channels)
    of the five Swin blocks of a group with `num_heads`."""
    ed, gc = cfg["embed_dim"], cfg["gc"]
    _, shift = window(cfg)
    out = []
    for j in range(1, 6):
        c = ed + (j - 1) * gc
        heads = num_heads if j == 1 or c % num_heads == 0 else num_heads - c % num_heads
        hidden = int(c * (cfg["mlp_ratio"] if j <= 3 else 1.0))
        out.append((c, heads, hidden, 0 if j % 2 else shift, ed if j == 5 else gc))
    return out


def param_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is 'conv' (uniform
    +-1/sqrt(fan_in)), 'normal' (std 0.02) or 'scale' (1 + normal 0.02)."""
    ed, nf, cin = cfg["embed_dim"], cfg["num_feat"], cfg["in_channels"]
    ws, _ = window(cfg)

    def norm(p, c):
        return [(f"{p}.scale", (c,), "scale"), (f"{p}.bias", (c,), "normal")]

    def dense(p, n_out, n_in):
        return [(f"{p}.weight", (n_out, n_in), "normal"), (f"{p}.bias", (n_out,), "normal")]

    def conv(p, n_out, n_in, k=3):
        return [(f"{p}.weight", (n_out, n_in, k, k), "conv"), (f"{p}.bias", (n_out,), "conv")]

    out = conv("conv_first", ed, cin) + norm("patch_embed_norm", ed)
    for i, heads in enumerate(cfg["num_heads"]):
        for j, (c, h, hidden, _, c_out) in enumerate(blocks(cfg, heads), 1):
            p = f"layers_{i}.swin{j}"
            out += norm(f"{p}.norm1", c)
            out += [(f"{p}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, h), "normal")]
            out += dense(f"{p}.attn.qkv", 3 * c, c) + dense(f"{p}.attn.proj", c, c)
            out += norm(f"{p}.norm2", c)
            out += dense(f"{p}.mlp.fc1", hidden, c) + dense(f"{p}.mlp.fc2", c, hidden)
            out += conv(f"layers_{i}.adjust{j}", c_out, c, 1)
    out += norm("norm", ed) + conv("conv_after_body", ed, ed)
    out += conv("conv_before_upsample", nf, ed)
    for k in range(int(math.log2(cfg["upscale"]))):
        out += conv(f"upsample.conv_{k}", 4 * nf, nf)
    return out + conv("conv_last", cin, nf)


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Tensor]:
    """Seeded weights made on `device` in two draws (one normal, one
    uniform over every parameter), scaled per init and cast to `dtype`;
    conv_last's bias is the configuration's `out_bias`, so that the raw
    output centres inside the engine's [0, 1] clip as a trained model's
    does. The bias tables are drawn (normal 0.02), not zero, so that a
    wrong index shows."""
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
        else:
            v = 0.02 * normal[at : at + n]
        out[name] = v.reshape(shape).to(dtype)
        at += n
    out["conv_last.bias"].fill_(cfg["out_bias"])
    return out


def _swin(w, p: str, x: Tensor, heads: int, ws: int, shift: int, q: Quant) -> Tensor:
    b, h, wd, c = x.shape
    n = ws * ws
    y = _ln(w, f"{p}.norm1", x)
    s = torch.roll(y, (-shift, -shift), (1, 2)) if shift else y
    qkv = _linear(w, f"{p}.attn.qkv", _windows(s, ws), q)
    table = w[f"{p}.attn.relative_position_bias_table"]
    bias = table[_rel_index(ws, x.device)].reshape(n, n, heads).permute(2, 0, 1)
    mask = shift_mask(h, wd, ws, shift, x.device) if shift else None
    qh, kh, vh = (_heads(t, heads) for t in qkv.split(c, -1))
    a = _attention(qh * (c // heads) ** -0.5, kh, vh, bias, mask, q)
    a = _image(_linear(w, f"{p}.attn.proj", _merge(a), q), ws, b, h, wd)
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    x = x + a
    return x + _mlp(w, p, x, q)


def _rdg(w, p: str, x: Tensor, num_heads: int, cfg: dict, q: Quant) -> Tensor:
    ws, _ = window(cfg)
    feats = x
    for j, (_, heads, _, shift, _) in enumerate(blocks(cfg, num_heads), 1):
        t = _pointwise(w, f"{p}.adjust{j}", _swin(w, f"{p}.swin{j}", feats, heads, ws, shift, q),
                       q)
        if j < 5:
            t = F.leaky_relu(t, 0.2)
            feats = torch.cat([t, feats] if j == 1 else [feats, t], -1)
    return t * 0.2 + x


def model(w: Dict[str, Tensor], x: Tensor, cfg: dict, q: Quant = None) -> Tensor:
    """(B, H, W, in_channels) float32 normalized input -> raw output
    (B, up*H, up*W, in_channels), unclamped."""
    ws, _ = window(cfg)
    if x.shape[1] % ws or x.shape[2] % ws:
        raise ValueError(f"this reference runs whole windows: window {ws}, image "
                         f"{x.shape[1]} x {x.shape[2]}")
    feat = _conv(w, "conv_first", x, q)
    t = _ln(w, "patch_embed_norm", feat)
    for i, heads in enumerate(cfg["num_heads"]):
        t = _rdg(w, f"layers_{i}", t, heads, cfg, q)
    feat = _conv(w, "conv_after_body", _ln(w, "norm", t), q) + feat
    feat = F.leaky_relu(_conv(w, "conv_before_upsample", feat, q), 0.01)
    for k in range(int(math.log2(cfg["upscale"]))):
        y = _conv(w, f"upsample.conv_{k}", feat, q).permute(0, 3, 1, 2)
        feat = F.pixel_shuffle(y, 2).permute(0, 2, 3, 1)
    return _conv(w, "conv_last", feat, q)


def serve(w: Dict[str, Tensor], rates: Tensor, cfg: dict, dtype=torch.float32,
          q: Quant = None) -> tuple:
    """(B, H, W) rates -> (prediction (B, hr, hr), input half (B, lr, lr)),
    float32: `rrdb.prepare` and `rrdb.finish` around this model, one image
    at a time; `dtype` and `q` are the control's."""
    x, inp = prepare(rates, cfg, dtype)
    y = torch.cat([model(w, x[i : i + 1].float()[..., None], cfg, q) for i in range(len(x))])
    return finish(y[..., 0], cfg, dtype), inp


def weights(cfg: dict, seed: int, root, device) -> Dict[str, Tensor]:
    """The reference's own float32 copy of the seeded weights."""
    return {k: v.float() for k, v in make_params(cfg, seed, device).items()}
