"""Frozen plain reference of HAT SR serving (Chen et al. 2023, "Activating
More Pixels in Image Super-Resolution Transformer", arXiv:2205.04437), with
the pipeline's pre- and post-processing.

Plain `torch`, float32 with TF32 off, NHWC tokens, written from the paper
and the configuration; it imports nothing of the port. Parameter names
and shapes are the serving state_dict's (Flax names with '.'), so that the
benchmark hands one seeded dict to the program and to this reference.

    conv_first 3x3 -> LayerNorm -> RHAG x len(depths) [HAB x depth -> OCAB
    -> 3x3 conv -> + RHAG input] -> LayerNorm -> conv_after_body + skip ->
    conv_before_upsample, LeakyReLU 0.01 -> [conv 64 -> 256, pixel shuffle
    2] per factor of 2 -> conv_last

HAB, pre-norm: y = LN1(x); x + W-MSA(y) + conv_scale * CAB(y), then
x + MLP(LN2(x)), the MLP with exact GELU.
    W-MSA: ws x ws windows with the relative-position bias; in the odd
    blocks of a group the image is rolled by -ws // 2 first and back after,
    and logits between pixels of different regions of the rolled image get
    -100 (the shift mask).
    CAB: conv 3x3 C -> C // compress, GELU, conv 3x3 back to C, then
    channel attention: global mean, 1x1 C -> C // squeeze, ReLU, 1x1 back,
    sigmoid, times the CAB's features.
OCAB: queries from the ws x ws windows, keys and values from the wse x wse
windows centred on them (wse = ws + overlap * ws) over the image
zero-padded by (wse - ws) / 2, a bias per (query pixel, key pixel), then
proj + residual and MLP + residual, each after its LayerNorm.

Window rule (the configuration's): img_size // patch_size must exceed the
window, which then stays ws with shift ws // 2; the image must be whole
windows. At img 416, patch 16, window 16: 26 x 26 windows of 256 pixels,
shifted in every odd block, and OCAB's 256 x 576 attention. Clamped or
padded windows are refused rather than carried untested.

Departures from the paper, each the configuration's:
* `mlp_ratio` 4 in HABs and OCABs, where the paper's SR models use 2 (the
  run config leaves the class default of 4).
* No mean shift: with one input channel HAT's mean is 0 and its img_range
  1. No absolute position embedding and no drop path (serving).
* OCAB's bias index is HAT's published `calculate_rpi_oca`: per axis, key
  coordinate in the extended window minus query coordinate, plus
  ws - wse + 1, rows times ws + wse - 1 plus columns. That offset leaves
  indices below zero, which the published code's torch indexing wraps;
  here they are taken modulo the table's size. Each displacement still
  has an entry of its own.
* Seeded weights, conv_last's bias `out_bias` (`make_params`).

`quant`, when given, is applied to both operands of every convolution and
matrix product (the control's lower precision); LayerNorm, softmax, GELU
and sigmoid stay float32. `serve` runs one image at a time, so that the
attention logits of a full-size image (2.4 GB in OCAB) fit on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .rrdb import finish, prepare
from .swinir import Quant, _conv, _linear, _ln, _mm, _rel_index, fp8  # noqa: F401

Tensor = torch.Tensor


def window(cfg: dict) -> Tuple[int, int, int]:
    """(window, shift of the odd blocks, OCAB's extended window)."""
    ws = cfg["window_size"]
    if cfg["img_size"] // cfg["patch_size"] <= ws:
        raise ValueError(f"this reference runs unclamped, shifted windows: img_size "
                         f"{cfg['img_size']} // patch_size {cfg['patch_size']} <= window {ws}")
    return ws, ws // 2, ws + int(cfg["overlap_ratio"] * ws)


def param_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is 'conv' (uniform
    +-1/sqrt(fan_in)), 'normal' (std 0.02) or 'scale' (1 + normal 0.02)."""
    ed, nf, cin = cfg["embed_dim"], cfg["num_feat"], cfg["in_channels"]
    ws, _, wse = window(cfg)
    hidden = int(ed * cfg["mlp_ratio"])
    mid, sq = ed // cfg["compress_ratio"], ed // cfg["squeeze_factor"]

    def norm(p):
        return [(f"{p}.scale", (ed,), "scale"), (f"{p}.bias", (ed,), "normal")]

    def dense(p, n_out, n_in):
        return [(f"{p}.weight", (n_out, n_in), "normal"), (f"{p}.bias", (n_out,), "normal")]

    def conv(p, n_out, n_in, k=3):
        return [(f"{p}.weight", (n_out, n_in, k, k), "conv"), (f"{p}.bias", (n_out,), "conv")]

    def mlp(p):
        return dense(f"{p}.fc1", hidden, ed) + dense(f"{p}.fc2", ed, hidden)

    out = conv("conv_first", ed, cin) + norm("patch_embed_norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            p = f"layers_{i}.blocks_{j}"
            out += norm(f"{p}.norm1")
            out += conv(f"{p}.conv_block.cab_0", mid, ed) + conv(f"{p}.conv_block.cab_2", ed, mid)
            out += conv(f"{p}.conv_block.ca.attention_1", sq, ed, 1)
            out += conv(f"{p}.conv_block.ca.attention_3", ed, sq, 1)
            out += [(f"{p}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads),
                     "normal")]
            out += dense(f"{p}.attn.qkv", 3 * ed, ed) + dense(f"{p}.attn.proj", ed, ed)
            out += norm(f"{p}.norm2") + mlp(f"{p}.mlp")
        p = f"layers_{i}.overlap_attn"
        out += norm(f"{p}.norm1") + dense(f"{p}.qkv", 3 * ed, ed)
        out += [(f"{p}.relative_position_bias_table", ((ws + wse - 1) ** 2, heads), "normal")]
        out += dense(f"{p}.proj", ed, ed) + norm(f"{p}.norm2") + mlp(f"{p}.mlp")
        out += conv(f"layers_{i}.conv", ed, ed)
    out += norm("norm") + conv("conv_after_body", ed, ed) + conv("conv_before_upsample", nf, ed)
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


def _pointwise(w, name: str, x: Tensor, q: Quant) -> Tensor:
    """1x1 convolution of NHWC `x`: a product over channels."""
    k = w[f"{name}.weight"].flatten(1)
    if q is not None:
        k, x = q(k), q(x)
    return F.linear(x, k) + w[f"{name}.bias"]


def _windows(x: Tensor, ws: int) -> Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), row-major windows."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // ws, ws, wd // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _image(y: Tensor, ws: int, b: int, h: int, wd: int) -> Tensor:
    """`_windows` undone: (B * nW, ws * ws, C) -> (B, H, W, C)."""
    c = y.shape[-1]
    y = y.reshape(b, h // ws, wd // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h, wd, c)


def _overlap_windows(x: Tensor, ws: int, wse: int) -> Tensor:
    """(B, H, W, C) -> (B * nW, wse * wse, C): the wse x wse window centred
    on each ws x ws window, over the image zero-padded by (wse - ws) / 2."""
    p = (wse - ws) // 2
    t = F.pad(x, (0, 0, p, p, p, p)).unfold(1, wse, ws).unfold(2, wse, ws)
    b, nh, nw, c = t.shape[:4]  # (B, nH, nW, C, wse, wse)
    return t.permute(0, 1, 2, 4, 5, 3).reshape(b * nh * nw, wse * wse, c)


def shift_mask(h: int, w: int, ws: int, shift: int, device) -> Tensor:
    """(nW, ws * ws, ws * ws): 0 between pixels of one region of the image
    rolled by -shift, -100 between regions. Along each axis the regions
    end at n - ws, at n - shift and at n."""
    def region(n):
        i = torch.arange(n)
        return (i >= n - ws).long() + (i >= n - shift).long()

    label = (region(h)[:, None] * 3 + region(w)[None, :])[None, :, :, None]
    lw = _windows(label, ws)[..., 0]
    return torch.where(lw[:, :, None] != lw[:, None, :], -100.0, 0.0).to(device)


def oca_index(ws: int, wse: int, device) -> Tensor:
    """OCAB's bias index of (query pixel, key pixel), (ws * ws * wse * wse,),
    as the module docstring gives it."""
    def grid(n):
        return torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n),
                                          indexing="ij")).flatten(1)

    rel = grid(wse)[:, None, :] - grid(ws)[:, :, None] + (ws - wse + 1)  # 2, ws^2, wse^2
    idx = rel[0] * (ws + wse - 1) + rel[1]
    return (idx % (ws + wse - 1) ** 2).flatten().to(device)


def _attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, mask: Optional[Tensor],
               quant: Quant) -> Tensor:
    """softmax(q k^T + bias [+ mask]) v over (B * nW, heads, n, d), q
    scaled; bias (heads, n, m); mask (nW, n, m), the same for each image."""
    logits = _mm(q, k.transpose(-2, -1), quant) + bias
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.view(-1, nw, *logits.shape[1:]) + mask[None, :, None]).flatten(0, 1)
    return _mm(torch.softmax(logits, -1), v, quant)


def _heads(t: Tensor, heads: int) -> Tensor:
    """(B_, n, C) -> (B_, heads, n, C // heads)."""
    return t.reshape(*t.shape[:2], heads, -1).transpose(1, 2)


def _merge(t: Tensor) -> Tensor:
    """`_heads` undone."""
    return t.transpose(1, 2).flatten(2)


def _mlp(w, p: str, x: Tensor, q: Quant) -> Tensor:
    z = _linear(w, f"{p}.mlp.fc1", _ln(w, f"{p}.norm2", x), q)
    return _linear(w, f"{p}.mlp.fc2", F.gelu(z), q)


def _cab(w, p: str, y: Tensor, q: Quant) -> Tensor:
    t = _conv(w, f"{p}.cab_2", F.gelu(_conv(w, f"{p}.cab_0", y, q)), q)
    s = _pointwise(w, f"{p}.ca.attention_1", t.mean((1, 2), keepdim=True), q)
    return t * torch.sigmoid(_pointwise(w, f"{p}.ca.attention_3", torch.relu(s), q))


def _hab(w, p: str, x: Tensor, heads: int, ws: int, shift: int, cfg: dict,
         q: Quant) -> Tensor:
    b, h, wd, c = x.shape
    n = ws * ws
    y = _ln(w, f"{p}.norm1", x)
    conv_x = _cab(w, f"{p}.conv_block", y, q)
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
    x = x + a + cfg["conv_scale"] * conv_x
    return x + _mlp(w, p, x, q)


def _ocab(w, p: str, x: Tensor, heads: int, ws: int, wse: int, q: Quant) -> Tensor:
    b, h, wd, c = x.shape
    qkv = _linear(w, f"{p}.qkv", _ln(w, f"{p}.norm1", x), q)
    qh = _heads(_windows(qkv[..., :c], ws), heads)
    kv = _overlap_windows(qkv[..., c:], ws, wse)
    kh, vh = _heads(kv[..., :c], heads), _heads(kv[..., c:], heads)
    table = w[f"{p}.relative_position_bias_table"]
    bias = table[oca_index(ws, wse, x.device)].reshape(ws * ws, wse * wse, heads)
    a = _attention(qh * (c // heads) ** -0.5, kh, vh, bias.permute(2, 0, 1), None, q)
    x = x + _linear(w, f"{p}.proj", _image(_merge(a), ws, b, h, wd), q)
    return x + _mlp(w, p, x, q)


def model(w: Dict[str, Tensor], x: Tensor, cfg: dict, q: Quant = None) -> Tensor:
    """(B, H, W, in_channels) float32 normalized input -> raw output
    (B, up*H, up*W, in_channels), unclamped."""
    ws, shift, wse = window(cfg)
    if x.shape[1] % ws or x.shape[2] % ws:
        raise ValueError(f"this reference runs whole windows: window {ws}, image "
                         f"{x.shape[1]} x {x.shape[2]}")
    feat = _conv(w, "conv_first", x, q)
    t = _ln(w, "patch_embed_norm", feat)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        r = t
        for j in range(depth):
            t = _hab(w, f"layers_{i}.blocks_{j}", t, heads, ws, shift if j % 2 else 0, cfg, q)
        t = _ocab(w, f"layers_{i}.overlap_attn", t, heads, ws, wse, q)
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
    float32: `rrdb.prepare` and `rrdb.finish` around this model, one image
    at a time; `dtype` and `q` are the control's."""
    x, inp = prepare(rates, cfg, dtype)
    y = torch.cat([model(w, x[i : i + 1].float()[..., None], cfg, q) for i in range(len(x))])
    return finish(y[..., 0], cfg, dtype), inp


def weights(cfg: dict, seed: int, root, device) -> Dict[str, Tensor]:
    """The reference's own float32 copy of the seeded weights."""
    return {k: v.float() for k, v in make_params(cfg, seed, device).items()}
