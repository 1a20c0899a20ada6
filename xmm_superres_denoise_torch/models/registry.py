"""Model registry: config -> PyTorch module.

The port of the JAX package's `models/registry.py`. For esr_gen the SR
upscale count is derived from hr/lr resolution: the scale must be a power
of two >= 2, one x2 PixelShuffle stage per factor of two. The Swin family
(swinir, swinfir, drct, hat) is built by `models/swin_zoo.py` with
upscale = hr // lr; Restormer takes the registry's dim and its own
defaults for the rest, as in JAX. `memory_efficient` checkpoints each RRDB
or each transformer block (`torch.utils.checkpoint`); `scan_layers` is
refused for the models that have no scanned form.
"""

from __future__ import annotations

import math
from typing import Tuple

from torch import nn

from ..config.schema import BaseModels, ModelCfg
from .rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR

_SWIN = (BaseModels.SWINIR, BaseModels.SWINFIR, BaseModels.DRCT, BaseModels.HAT)


def build_model(
    config: ModelCfg, lr_shape: Tuple[int, int], hr_shape: Tuple[int, int]
) -> nn.Module:
    name = BaseModels(config.name)
    m = config.model

    if config.scan_layers and name not in _SWIN:
        # the flag exists to compress repeated transformer group stacks;
        # silently ignoring it would hide a config mistake
        raise ValueError(
            f"scan_layers is a Swin-family knob (swinir/swinfir/drct/hat); "
            f"{name.value} has no scanned form")

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
            memory_efficient=config.memory_efficient,
        )

    if name is BaseModels.RRDB_DENOISE:
        return GeneratorRRDB_DN(
            in_channels=m.in_channels,
            out_channels=m.out_channels,
            num_filters=m.filters,
            num_res_blocks=m.residual_blocks,
            memory_efficient=config.memory_efficient,
        )

    if name in _SWIN:
        from .swin_zoo import build_swin_family

        return build_swin_family(name, m, upscale=hr_shape[0] // lr_shape[0],
                                 memory_efficient=config.memory_efficient,
                                 scan_layers=config.scan_layers)

    if name is BaseModels.RESTORMER:
        from .restormer import Restormer

        return Restormer(inp_channels=m.in_channels, out_channels=m.out_channels, dim=m.dim)

    raise ValueError(f"Unknown model {name}")
