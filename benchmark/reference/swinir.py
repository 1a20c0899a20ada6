"""Frozen plain reference of SwinIR SR serving (Liang et al. 2021,
arXiv:2108.10257), with the pipeline's pre- and post-processing.

Plain `torch`, float32 with TF32 off, NHWC tokens, written from the paper
and the configuration; it imports nothing of the port. Parameter names
and shapes are the serving state_dict's (Flax names with '.'), so that the
benchmark hands one seeded dict to the program and to this reference.

    conv_first 3x3 -> LayerNorm -> RSTB x len(depths) [Swin blocks (W-MSA
    with relative position bias; MLP 4x with exact GELU; pre-norm
    residuals) -> 3x3 conv -> + RSTB input] -> LayerNorm -> conv_after_body
    + skip -> conv_before_upsample, LeakyReLU 0.01 -> [conv 64 -> 256,
    pixel shuffle 2] per factor of 2 -> conv_last

Window rule (the configuration's): the window is clamped to
img_size // patch_size when that is not larger than it, and the shift is
then 0; at img 416, patch 32 the model runs 13 x 13 windows, unshifted,
which tile 416 exactly. Shifted windows and the reflect pad to a multiple
of the window are SwinIR's too, but no configuration here runs them, so
this reference refuses them rather than carry them untested.

`quant`, when given, is applied to both operands of every convolution and
matrix product (the control's lower precision); LayerNorm, softmax and
GELU stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .rrdb import finish, prepare

Tensor = torch.Tensor
Quant = Optional[Callable[[Tensor], Tensor]]


def window(cfg: dict) -> Tuple[int, int]:
    """(window, shift of the odd blocks) after the clamp rule."""
    res = cfg["img_size"] // cfg["patch_size"]
    if res <= cfg["window_size"]:
        return res, 0
    return cfg["window_size"], cfg["window_size"] // 2


def param_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is 'conv' (uniform
    +-1/sqrt(fan_in)), 'normal' (std 0.02) or 'scale' (1 + normal 0.02)."""
    ed, nf, cin = cfg["embed_dim"], cfg["num_feat"], cfg["in_channels"]
    ws, _ = window(cfg)
    hidden = int(ed * cfg["mlp_ratio"])
    out = [("conv_first.weight", (ed, cin, 3, 3), "conv"), ("conv_first.bias", (ed,), "conv"),
           ("patch_embed_norm.scale", (ed,), "scale"), ("patch_embed_norm.bias", (ed,), "normal")]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            p = f"layers_{i}.residual_group.blocks_{j}"
            out += [
                (f"{p}.norm1.scale", (ed,), "scale"), (f"{p}.norm1.bias", (ed,), "normal"),
                (f"{p}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads), "normal"),
                (f"{p}.attn.qkv.weight", (3 * ed, ed), "normal"),
                (f"{p}.attn.qkv.bias", (3 * ed,), "normal"),
                (f"{p}.attn.proj.weight", (ed, ed), "normal"),
                (f"{p}.attn.proj.bias", (ed,), "normal"),
                (f"{p}.norm2.scale", (ed,), "scale"), (f"{p}.norm2.bias", (ed,), "normal"),
                (f"{p}.mlp.fc1.weight", (hidden, ed), "normal"),
                (f"{p}.mlp.fc1.bias", (hidden,), "normal"),
                (f"{p}.mlp.fc2.weight", (ed, hidden), "normal"),
                (f"{p}.mlp.fc2.bias", (ed,), "normal"),
            ]
        out += [(f"layers_{i}.conv.weight", (ed, ed, 3, 3), "conv"),
                (f"layers_{i}.conv.bias", (ed,), "conv")]
    out += [("norm.scale", (ed,), "scale"), ("norm.bias", (ed,), "normal"),
            ("conv_after_body.weight", (ed, ed, 3, 3), "conv"),
            ("conv_after_body.bias", (ed,), "conv"),
            ("conv_before_upsample.weight", (nf, ed, 3, 3), "conv"),
            ("conv_before_upsample.bias", (nf,), "conv")]
    for k in range(int(math.log2(cfg["upscale"]))):
        out += [(f"upsample.conv_{k}.weight", (4 * nf, nf, 3, 3), "conv"),
                (f"upsample.conv_{k}.bias", (4 * nf,), "conv")]
    out += [("conv_last.weight", (cin, nf, 3, 3), "conv"), ("conv_last.bias", (cin,), "conv")]
    return out


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Tensor]:
    """Seeded weights made on `device` in two draws (one normal, one
    uniform over every parameter), scaled per init and cast to `dtype`;
    conv_last's bias is the configuration's `out_bias`, so that the raw
    output centres inside the engine's [0, 1] clip as a trained model's
    does (drawn, it centres on 0 and the clip zeroes half the pixels)."""
    spec = param_shapes(cfg)
    sizes = [math.prod(s) for _, s, _ in spec]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, init), n in zip(spec, sizes):
        if init == "conv":
            fan_in = math.prod(shape[1:]) if len(shape) == 4 else None
            if fan_in is None:  # a bias: the fan-in of its weight
                fan_in = math.prod(out[name[: -len("bias")] + "weight"].shape[1:])
            v = uniform[at : at + n] / math.sqrt(fan_in)
        elif init == "scale":
            v = 1.0 + 0.02 * normal[at : at + n]
        else:
            v = 0.02 * normal[at : at + n]
        out[name] = v.reshape(shape).to(dtype)
        at += n
    out["conv_last.bias"].fill_(cfg["out_bias"])
    return out


def _conv(w, name: str, x: Tensor, q: Quant) -> Tensor:
    """3x3 SAME convolution of NHWC `x`, bias added after."""
    k, x = w[f"{name}.weight"], x.permute(0, 3, 1, 2)
    if q is not None:
        k, x = q(k), q(x)
    return F.conv2d(x, k, padding=1).permute(0, 2, 3, 1) + w[f"{name}.bias"]


def _linear(w, name: str, x: Tensor, q: Quant) -> Tensor:
    k = w[f"{name}.weight"]
    if q is not None:
        k, x = q(k), q(x)
    return F.linear(x, k) + w[f"{name}.bias"]


def _mm(a: Tensor, b: Tensor, q: Quant) -> Tensor:
    if q is not None:
        a, b = q(a), q(b)
    return torch.matmul(a, b)


def _ln(w, name: str, x: Tensor) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.scale"], w[f"{name}.bias"], 1e-5)


def _rel_index(ws: int, device) -> Tensor:
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).flatten().to(device)


def _block(w, p: str, x: Tensor, heads: int, ws: int, q: Quant) -> Tensor:
    b, h, wd, c = x.shape
    n, d = ws * ws, c // heads
    y = _ln(w, f"{p}.norm1", x)
    y = y.reshape(b, h // ws, ws, wd // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, n, c)
    qkv = _linear(w, f"{p}.attn.qkv", y, q).reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    logits = _mm(qkv[0] * d ** -0.5, qkv[1].transpose(-2, -1), q)
    table = w[f"{p}.attn.relative_position_bias_table"]
    logits = logits + table[_rel_index(ws, x.device)].reshape(n, n, heads).permute(2, 0, 1)
    y = _mm(torch.softmax(logits, -1), qkv[2], q).transpose(1, 2).reshape(-1, n, c)
    y = _linear(w, f"{p}.attn.proj", y, q)
    y = y.reshape(b, h // ws, wd // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, c)
    x = x + y
    z = _linear(w, f"{p}.mlp.fc1", _ln(w, f"{p}.norm2", x), q)
    return x + _linear(w, f"{p}.mlp.fc2", F.gelu(z), q)


def model(w: Dict[str, Tensor], x: Tensor, cfg: dict, q: Quant = None) -> Tensor:
    """(B, H, W, in_channels) float32 normalized input -> raw output
    (B, up*H, up*W, in_channels), unclamped."""
    h_in, w_in = x.shape[1:3]
    ws, shift = window(cfg)
    if shift or h_in % ws or w_in % ws:
        raise ValueError(f"this reference runs whole, unshifted windows: window {ws}, shift "
                         f"{shift}, image {h_in} x {w_in}")
    feat = _conv(w, "conv_first", x, q)
    t = _ln(w, "patch_embed_norm", feat)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        r = t
        for j in range(depth):
            t = _block(w, f"layers_{i}.residual_group.blocks_{j}", t, heads, ws, q)
        t = _conv(w, f"layers_{i}.conv", t, q) + r
    feat = _conv(w, "conv_after_body", _ln(w, "norm", t), q) + feat
    feat = F.leaky_relu(_conv(w, "conv_before_upsample", feat, q), 0.01)
    for k in range(int(math.log2(cfg["upscale"]))):
        y = _conv(w, f"upsample.conv_{k}", feat, q).permute(0, 3, 1, 2)
        feat = F.pixel_shuffle(y, 2).permute(0, 2, 3, 1)
    return _conv(w, "conv_last", feat, q)


def serve(w: Dict[str, Tensor], rates: Tensor, cfg: dict, dtype=torch.float32,
          q: Quant = None) -> tuple:
    """(B, H, W) rates -> (prediction (B, hr, hr), input half (B, lr, lr)),
    float32: `rrdb.prepare` and `rrdb.finish` around this model; `dtype`
    and `q` are the control's."""
    x, inp = prepare(rates, cfg, dtype)
    return finish(model(w, x.float()[..., None], cfg, q)[..., 0], cfg, dtype), inp


def weights(cfg: dict, seed: int, root, device) -> Dict[str, Tensor]:
    """The reference's own float32 copy of the seeded weights."""
    return {k: v.float() for k, v in make_params(cfg, seed, device).items()}


def fp8(t: Tensor) -> Tensor:
    """Per-tensor scaled float8 e4m3 round trip: the control's precision."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
