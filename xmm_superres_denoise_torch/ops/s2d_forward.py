"""Whole-forward space-to-depth pipelines for the RRDB generators.

The port of the JAX package's `ops/s2d_forward.py`. The whole
GeneratorRRDB_SR / _DN forward runs in the 2x2 space-to-depth domain
(`ops/space_to_depth.py`): every 3x3 convolution becomes the exactly
equivalent 3x3 convolution at half resolution with 4x the channels, 128 at
esr_gen width. The trunk's 12 dense blocks run on K1
(`ops/dense_block_s2d.py`: the CUDA kernel on the card, its plain version on
the CPU); the five outer convolutions are cuDNN `F.conv2d`, as the JAX
package leaves them to XLA. f32 runs with TF32 off (`true_f32`).

The SR head: the upconv output in the S2D domain is the S2D^2 form of the
pixel-shuffled 832^2 tensor, so one `d2s` moves it to the S2D^1 domain
(416^2, 128 channels) where HRconv and conv_last run (4x their nominal
FLOPs rather than 16x at S2D^2), and a last `d2s` gives the 832^2 output.

`params` is the Flax-layout tree (any source `utils.weights.flax_tree`
takes); weights are transformed in f32 numpy and only then cast to the
forward's dtype.

`make_s2d_train_apply` is the training route (`model.s2d_train`): the
model's own forward with its RRDB chain in the S2D domain, each dense block
on K1 through `dense_block_s2d_train` (gradients recomputed in the original
domain); see `models/rrdb.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR, conv3x3_nhwc
from ..utils.weights import flax_tree
from .dense_block import pack_weights, rrdb_chain
from .dense_block_s2d import dense_block_s2d
from .precision import lrelu, true_f32
from .space_to_depth import d2s, s2d, s2d_conv_weights

Tensor = torch.Tensor


def _xform(entry: dict, times: int, dtype, device="cpu") -> Tuple[Tensor, Tensor]:
    """A Flax conv entry moved `times` times into the S2D domain in f32
    numpy, then cast to `dtype` on `device`: (w HWIO, b)."""
    w = np.asarray(entry["kernel"], np.float32)
    b = np.asarray(entry["bias"], np.float32)
    for _ in range(times):
        w, b = s2d_conv_weights(w, b)
    return torch.from_numpy(w).to(device, dtype), torch.from_numpy(b).to(device, dtype)


def _transform_trunk(trunk: dict, num_res_blocks: int, dtype, device="cpu") -> Dict[str, Any]:
    """The trunk's weights in the S2D domain: conv_first, trunk_conv and
    blocks[i][d][level] as (w HWIO, b) of `dtype` on `device`."""
    out: Dict[str, Any] = {
        "conv_first": _xform(trunk["conv_first"], 1, dtype, device),
        "trunk_conv": _xform(trunk["trunk_conv"], 1, dtype, device),
        "blocks": [],
    }
    for i in range(num_res_blocks):
        rrdb = trunk[f"rrdb_{i}"]
        out["blocks"].append([
            [_xform(rrdb[f"RDB{d}"][f"conv{c}"], 1, dtype, device) for c in range(1, 6)]
            for d in (1, 2, 3)
        ])
    return out


def _conv_ready(pair: Tuple[Tensor, Tensor]) -> Tuple[Tensor, Tensor]:
    """(w HWIO, b) -> (w OIHW contiguous, b) for `conv3x3_nhwc`, once."""
    w, b = pair
    return w.permute(3, 2, 0, 1).contiguous(), b


def _prepare_trunk(tp: Dict[str, Any]) -> Dict[str, Any]:
    """Lay the transformed trunk out once for the forward: outer convs as
    OIHW, each dense block packed for K1."""
    return {
        "conv_first": _conv_ready(tp["conv_first"]),
        "trunk_conv": _conv_ready(tp["trunk_conv"]),
        "blocks": [
            [pack_weights([w for w, _ in rdb], [b for _, b in rdb], rdb[0][0].dtype)
             for rdb in rrdb]
            for rrdb in tp["blocks"]
        ],
    }


def _trunk_forward(tp: Dict[str, Any], x4: Tensor) -> Tensor:
    """S2D-domain trunk: conv_first -> N x RRDB (dense blocks on K1) ->
    trunk_conv + skip. `tp` comes from `_prepare_trunk`."""
    fea = conv3x3_nhwc(x4, *tp["conv_first"])
    _, h, w, _ = x4.shape
    # K1's tiling arguments only restrict shapes; one tile of the whole
    # image takes any H and W
    t = rrdb_chain(fea.contiguous(), tp["blocks"],
                   lambda t, packed: dense_block_s2d(t, packed, h_strip=h, w_tile=w))
    return fea + conv3x3_nhwc(t, *tp["trunk_conv"])


def _maybe_true_f32(forward, dtype):
    """f32 is the parity class: run it with TF32 off."""
    if dtype != torch.float32:
        return forward

    def forward_f32(x: Tensor) -> Tensor:
        with true_f32():
            return forward(x)

    return forward_f32


def make_s2d_sr_forward(model: GeneratorRRDB_SR, params, dtype=torch.bfloat16, device="cuda:0"):
    """An S2D-domain forward equal to clip(model(x), 0, 1) (up to dtype), for
    num_upsample == 1. Input (B, H, W, C) NHWC with H, W divisible by 2;
    output (B, 2H, 2W, out_channels) in `dtype`."""
    if model.num_upsample != 1:
        raise ValueError(f"the S2D forward is built for num_upsample == 1, got {model.num_upsample}")
    p = flax_tree(params)
    tp = _prepare_trunk(_transform_trunk(p["trunk"], model.trunk.num_res_blocks, dtype, device))
    upconv = _conv_ready(_xform(p["upconv_0"], 1, dtype, device))
    hrconv = _conv_ready(_xform(p["HRconv"], 1, dtype, device))
    conv_last = _conv_ready(_xform(p["conv_last"], 1, dtype, device))

    def forward(x: Tensor) -> Tensor:
        x4 = s2d(x.to(dtype))
        fea = _trunk_forward(tp, x4)
        up = lrelu(conv3x3_nhwc(fea, *upconv), 0.01)  # == S2D^2 of the shuffled tensor
        h = lrelu(conv3x3_nhwc(d2s(up), *hrconv), 0.2)  # S2D^1: 2H x 2W / 2, 4 * nf
        out = conv3x3_nhwc(h, *conv_last)
        return torch.clamp(d2s(out), 0.0, 1.0)

    return _maybe_true_f32(forward, dtype)


def make_s2d_dn_forward(model: GeneratorRRDB_DN, params, dtype=torch.bfloat16, device="cuda:0"):
    """S2D-domain denoiser forward: trunk -> conv_last -> input skip -> clip."""
    p = flax_tree(params)
    tp = _prepare_trunk(_transform_trunk(p["trunk"], model.trunk.num_res_blocks, dtype, device))
    conv_last = _conv_ready(_xform(p["conv_last"], 1, dtype, device))

    def forward(x: Tensor) -> Tensor:
        x4 = s2d(x.to(dtype))
        fea = _trunk_forward(tp, x4)
        out = conv3x3_nhwc(fea, *conv_last) + x4
        return torch.clamp(d2s(out), 0.0, 1.0)

    return _maybe_true_f32(forward, dtype)


def make_s2d_train_apply(model, remat: bool = False):
    """`apply(module, x)` equal to the model's forward (which clips to
    [0, 1], once, as the JAX S2D apply does), differentiable with respect
    to the model's own parameters, with the RRDB chain in the S2D domain:
    each dense block runs on K1 (`ops/dense_block_s2d.py:
    dense_block_s2d_train`, one autograd node whose backward recomputes
    the block in the original domain, so the gradients are exact). The
    five outer convolutions run in the original domain: the same function
    as JAX's S2D-domain convolutions, with a quarter of the multiply-adds.

    `module` is `model` or a wrapping of it (DDP, or `model` under FSDP);
    `remat=True` checkpoints each dense block (`memory_efficient`). Supports
    GeneratorRRDB_SR with num_upsample == 1 and GeneratorRRDB_DN, as the
    JAX version does."""
    if isinstance(model, GeneratorRRDB_SR):
        if model.num_upsample != 1:
            raise ValueError(f"the S2D apply is built for num_upsample == 1, got "
                             f"{model.num_upsample}")
    elif not isinstance(model, GeneratorRRDB_DN):
        raise TypeError(f"the S2D apply takes the RRDB generators, got {type(model).__name__}")

    def apply(module, x: Tensor) -> Tensor:
        return module(x, s2d=True, remat=remat)

    return apply
