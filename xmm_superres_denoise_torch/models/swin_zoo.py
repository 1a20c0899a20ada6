"""Builder for the Swin-family models from a `TransformerCfg`.

The port of the JAX package's `models/swin_zoo.py`: the config's fields
map 1:1 onto the model's arguments; `upscale` comes from the hr/lr
resolution (the reference leaves the models' default 2, which is the
production 416 -> 832 task) and `use_checkpoint` from `memory_efficient`.
"""

from __future__ import annotations

from ..config.schema import BaseModels, TransformerCfg
from .drct import DRCT
from .hat import HAT
from .swinir import SwinIR


def build_swin_family(name: BaseModels, cfg: TransformerCfg, upscale: int,
                      memory_efficient: bool = False, scan_layers: bool = False):
    common = dict(
        img_size=cfg.img_size, patch_size=cfg.patch_size, window_size=cfg.window_size,
        embed_dim=cfg.embed_dim, num_heads=tuple(cfg.num_heads), depths=tuple(cfg.depths),
        upsampler=cfg.upsampler, in_chans=cfg.in_channels, use_checkpoint=memory_efficient,
        upscale=upscale, scan_layers=scan_layers,
    )
    if name is BaseModels.SWINIR:
        return SwinIR(resi_connection="1conv", **common)
    if name is BaseModels.SWINFIR:
        return SwinIR(resi_connection="SFB", **common)
    if name is BaseModels.DRCT:
        if cfg.upsampler != "pixelshuffle":
            # no silent coercion: '' (the SwinIR denoise-head selector) would
            # otherwise build an SR reconstruction head the config did not ask for
            raise ValueError("DRCT supports model.upsampler='pixelshuffle' only, got "
                             f"{cfg.upsampler!r}")
        return DRCT(**common)
    if name is BaseModels.HAT:
        return HAT(**common)
    raise ValueError(name)
