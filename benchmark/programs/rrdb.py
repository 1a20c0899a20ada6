"""esr_gen through the port: `InferenceEngine` with the trained weights
read by the port's own Flax reader, in the configuration's dtype. The
control is the port's int8 path (`quantize=True`, K3), the step below
bfloat16 that the program has of its own."""

from __future__ import annotations

import torch

from ..reference import rrdb as reference
from . import DTYPES, dataset_config


def model_config(cfg: dict):
    from xmm_superres_denoise_torch.config import ModelCfg

    return ModelCfg(
        name=cfg["model"], batch_size=cfg["batch_size"],
        model={"base_model": cfg["model"], "in_channels": cfg["in_channels"],
               "out_channels": cfg["out_channels"], "filters": cfg["filters"],
               "residual_blocks": cfg["residual_blocks"]},
    )


def build(cfg: dict, seed: int, root, device: str, quantize: bool = False):
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine
    from xmm_superres_denoise_torch.utils.weights import params_from_flax

    params = params_from_flax(reference.checked_path(cfg, root))
    return InferenceEngine(model_config(cfg), dataset_config(cfg), params,
                           dtype=DTYPES[cfg["dtype"]], quantize=quantize, device=device)


def control(cfg: dict, seed: int, root, device: str):
    """stack -> (prediction of the int8 engine, input half of the reference
    prepared in bfloat16)."""
    engine = build(cfg, seed, root, device, quantize=True)

    def serve(stack):
        pred, _ = engine.run_tiles(stack, batch_size=cfg["batch_size"])
        with torch.inference_mode():
            _, inp = reference.prepare(torch.from_numpy(stack).to(device), cfg, torch.bfloat16)
        return pred, inp.cpu().numpy()

    return serve


def counters() -> dict:
    """The port's launch counters this family drives: K2's."""
    from xmm_superres_denoise_torch.ops.dense_block import dense_block

    return {"k2_launches": dense_block.launches}


def expected_counters(cfg: dict, chunks: int) -> dict:
    """Five level launches per dense block, 3 blocks per RRDB, per chunk."""
    return {"k2_launches": 5 * 3 * cfg["residual_blocks"] * chunks}
