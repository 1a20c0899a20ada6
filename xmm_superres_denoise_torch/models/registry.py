"""Model registry: config -> PyTorch module.

The port of the JAX package's `models/registry.py` for the two RRDB
models. The SR upscale count is derived from hr/lr resolution: the scale
must be a power of two >= 2, one x2 PixelShuffle stage per factor of two.
"""

from __future__ import annotations

import math
from typing import Tuple

from torch import nn

from ..config.schema import BaseModels, ModelCfg
from .rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR


def build_model(
    config: ModelCfg, lr_shape: Tuple[int, int], hr_shape: Tuple[int, int]
) -> nn.Module:
    name = BaseModels(config.name)
    m = config.model
    if config.memory_efficient:
        raise NotImplementedError(
            "memory_efficient (activation checkpointing) is refused until the training "
            "harness lands (ROADMAP.md Queue 1, training harness: torch.utils.checkpoint "
            "per RRDB, on the dense block's autograd route, ops/dense_block.py "
            "_DenseBlockFn, which already recomputes each block in its backward)"
        )

    if name is BaseModels.ESR_GEN:
        up_scale = hr_shape[0] / lr_shape[0]
        n_stages = math.log2(up_scale) if up_scale > 0 else -1.0
        if up_scale < 2 or n_stages != int(n_stages):
            raise ValueError(
                f"Upscaling must be a power-of-two multiple >= 2, got "
                f"{up_scale} (in_dims {lr_shape}, out_dims {hr_shape})"
            )
        return GeneratorRRDB_SR(
            in_channels=m.in_channels,
            out_channels=m.out_channels,
            num_filters=m.filters,
            num_res_blocks=m.residual_blocks,
            num_upsample=int(n_stages),
        )

    if name is BaseModels.RRDB_DENOISE:
        return GeneratorRRDB_DN(
            in_channels=m.in_channels,
            out_channels=m.out_channels,
            num_filters=m.filters,
            num_res_blocks=m.residual_blocks,
        )

    raise NotImplementedError(
        f"model {name.value!r} is not ported to the PyTorch package yet "
        "(ROADMAP.md Queue 1, transformer zoo)"
    )
