"""Restormer through the port: `InferenceEngine` built from the benchmark's
seeded state_dict, in the configuration's dtype, through the registry as
`cli serve` builds `restormer_denoise.toml`: a model section of
`base_model = "restormer"` and its `dim`, the rest the registry's
defaults. `build` refuses a model whose blocks, heads, expansion or biases
are not the configuration's, so the file cannot drift from the registry
unnoticed. The port has no path below bfloat16 for the zoo, so the
control is the reference with every product in float8 and the pipeline
around it in bfloat16."""

from __future__ import annotations

import torch

from ..reference import restormer as reference
from . import DTYPES, dataset_config


def model_config(cfg: dict):
    from xmm_superres_denoise_torch.config import ModelCfg

    return ModelCfg(name=cfg["model"], batch_size=cfg["batch_size"],
                    memory_efficient=cfg["memory_efficient"],
                    model={"base_model": cfg["model"], "in_channels": cfg["in_channels"],
                           "out_channels": cfg["out_channels"], "dim": cfg["dim"]})


def check_model(model, cfg: dict) -> None:
    """Raise unless the registry's model has the configuration's blocks,
    heads, GDFN expansion and convolution biases."""
    for name, n, c, heads in reference.stages(cfg):
        if model.stages.get(name) != n:
            raise ValueError(f"{name}: the registry built {model.stages.get(name)} blocks, "
                             f"the configuration states {n}")
        blk = getattr(model, f"{name}_0", None)
        if blk is None:
            continue
        hidden = int(c * cfg["ffn_expansion_factor"])
        got = (blk.attn.num_heads, blk.ffn.project_out.in_channels, blk.attn.qkv.bias is not None)
        if got != (heads, hidden, cfg["bias"]):
            raise ValueError(f"{name}: the registry built (heads, GDFN hidden, bias) {got}, "
                             f"the configuration states {(heads, hidden, cfg['bias'])}")


def build(cfg: dict, seed: int, root, device: str):
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine

    params = reference.make_params(cfg, seed, device, DTYPES[cfg["dtype"]])
    engine = InferenceEngine(model_config(cfg), dataset_config(cfg), params,
                             dtype=DTYPES[cfg["dtype"]], device=device)
    check_model(engine.model, cfg)
    return engine


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
    """Restormer's forward counts in the port (`models/restormer.py`); none
    from a port that keeps none."""
    from xmm_superres_denoise_torch.models.restormer import GDFN, MDTA

    if not hasattr(MDTA, "calls"):
        return {}
    return {"restormer_mdta_calls": MDTA.calls, "restormer_gdfn_calls": GDFN.calls}


def expected_counters(cfg: dict, chunks: int) -> dict:
    """Per chunk: one MDTA and one GDFN per block, 44 at [4, 6, 6, 8] and
    4 refinement blocks (the decoder repeats levels 3, 2 and 1)."""
    blocks = sum(n for _, n, _, _ in reference.stages(cfg)) * chunks
    return {"restormer_mdta_calls": blocks, "restormer_gdfn_calls": blocks}
