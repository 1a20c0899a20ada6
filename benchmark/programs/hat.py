"""HAT through the port: `InferenceEngine` built from the benchmark's
seeded state_dict, in the configuration's dtype, through the registry as
`cli serve` builds `hat_sr.toml`. Its model section has SwinIR's keys; the
compress, squeeze, conv_scale, overlap and MLP ratios are HAT's defaults,
which the configuration states for the reference. The port has no path
below bfloat16 for the zoo, so the control is the reference with every
product in float8 and the pipeline around it in bfloat16."""

from __future__ import annotations

import torch

from ..reference import hat as reference
from . import DTYPES, dataset_config
from .swinir import model_config  # the same model section


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


def counters() -> dict:
    """HAT's forward counts in the port (`models/hat.py`); none from a port
    that keeps none."""
    from xmm_superres_denoise_torch.models.hat import CAB, HAB, OCAB

    if not hasattr(HAB, "calls"):
        return {}
    return {"hat_hab_calls": HAB.calls, "hat_cab_calls": CAB.calls,
            "hat_ocab_calls": OCAB.calls, "hat_masked_attn_calls": HAB.masked_attn_calls}


def expected_counters(cfg: dict, chunks: int) -> dict:
    """Per chunk: a HAB and its CAB per block, an OCAB per group, the shift
    mask in every odd block of a group."""
    habs = sum(cfg["depths"]) * chunks
    return {"hat_hab_calls": habs, "hat_cab_calls": habs,
            "hat_ocab_calls": len(cfg["depths"]) * chunks,
            "hat_masked_attn_calls": sum(d // 2 for d in cfg["depths"]) * chunks}
