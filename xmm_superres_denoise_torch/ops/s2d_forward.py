"""The RRDB generators' space-to-depth weight transform, and their S2D
training route.

The port of the parts of the JAX package's `ops/s2d_forward.py` that the
port runs. `_xform` and `_transform_trunk` move Flax-layout weights (any
source `utils.weights.flax_tree` takes) into the 2x2 space-to-depth domain
(`ops/space_to_depth.py`): every 3x3 convolution becomes the exactly
equivalent 3x3 convolution at half resolution with 4x the channels, 128 at
esr_gen width. Weights are transformed in f32 numpy and only then cast.
int8 serving (`ops/int8_forward.py`) builds on them, with `_conv_ready` and
`_maybe_true_f32` (f32 runs with TF32 off, `true_f32`).

`make_s2d_train_apply` is the training route (`model.s2d_train`): the
model's own forward with its RRDB chain in the S2D domain, each dense block
on K1 through `dense_block_s2d_train` (gradients recomputed in the original
domain); see `models/rrdb.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from .precision import true_f32
from .space_to_depth import s2d_conv_weights

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


def _maybe_true_f32(forward, dtype):
    """f32 is the parity class: run it with TF32 off."""
    if dtype != torch.float32:
        return forward

    def forward_f32(x: Tensor) -> Tensor:
        with true_f32():
            return forward(x)

    return forward_f32


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
