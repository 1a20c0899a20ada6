"""SwinIR through the port: `InferenceEngine` built from the benchmark's
seeded state_dict, in the configuration's dtype. The port has no path
below bfloat16 for the zoo, so the control is the reference with every
product in float8 and the pipeline around it in bfloat16."""

from __future__ import annotations

import torch

from ..reference import swinir as reference
from . import DTYPES, dataset_config


def model_config(cfg: dict):
    from xmm_superres_denoise_torch.config import ModelCfg

    keys = ("img_size", "patch_size", "window_size", "embed_dim", "depths", "num_heads",
            "upsampler", "in_channels")
    return ModelCfg(name=cfg["model"], batch_size=cfg["batch_size"],
                    memory_efficient=cfg["memory_efficient"],
                    model={"base_model": cfg["model"], **{k: cfg[k] for k in keys}})


def build(cfg: dict, seed: int, root, device: str):
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine

    params = reference.make_params(cfg, seed, device, DTYPES[cfg["dtype"]])
    return InferenceEngine(model_config(cfg), dataset_config(cfg), params,
                           dtype=DTYPES[cfg["dtype"]], device=device)


def control(cfg: dict, seed: int, root, device: str):
    """stack -> the reference in float8 with bfloat16 pre- and post-processing."""
    w = reference.weights(cfg, seed, root, device)

    def serve(stack):
        with torch.inference_mode():
            pred, inp = reference.serve(w, torch.from_numpy(stack).to(device), cfg,
                                        torch.bfloat16, reference.fp8)
        return pred.cpu().numpy(), inp.cpu().numpy()

    return serve
