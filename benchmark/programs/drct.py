"""DRCT through the port: `InferenceEngine` built from the benchmark's
seeded state_dict, in the configuration's dtype, through the registry as
`cli serve` builds a DRCT run config. Its model section has SwinIR's keys;
the dense growth, the MLP ratio and num_feat are the port's class
defaults, which the configuration states for the reference, and `build`
refuses a model whose groups, heads, MLP widths, windows, shifts or adjust
convolutions are not the configuration's, so the file cannot drift from
the registry unnoticed. The port has no path below bfloat16 for the zoo,
so the control is the reference with every product in float8 and the
pipeline around it in bfloat16."""

from __future__ import annotations

import torch

from ..reference import drct as reference
from . import DTYPES, dataset_config
from .swinir import model_config  # the same model section


def check_model(model, cfg: dict) -> None:
    """Raise unless the registry's model has the configuration's groups and,
    in each, its five blocks' widths, heads, MLP widths, window and shift,
    and adjust widths."""
    if getattr(model, "n_layers", None) != len(cfg["num_heads"]):
        raise ValueError(f"the registry built {getattr(model, 'n_layers', None)} groups, the "
                         f"configuration states {len(cfg['num_heads'])}")
    ws, _ = reference.window(cfg)
    for i, heads in enumerate(cfg["num_heads"]):
        group = getattr(model, f"layers_{i}")
        for j, (c, h, hidden, shift, c_out) in enumerate(reference.blocks(cfg, heads), 1):
            blk, adj = getattr(group, f"swin{j}"), getattr(group, f"adjust{j}")
            got = (blk.norm1.scale.shape[0], blk.attn.num_heads, blk.mlp.fc1.out_features,
                   blk.ws, blk.shift, adj.out_channels)
            want = (c, h, hidden, ws, shift, c_out)
            if got != want:
                raise ValueError(f"layers_{i}.swin{j}: the registry built (channels, heads, MLP "
                                 f"hidden, window, shift, adjust out) {got}, the configuration "
                                 f"states {want}")


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
    """DRCT's forward counts in the port (`models/drct.py`); none from a
    port that keeps none."""
    from xmm_superres_denoise_torch.models.drct import RDG

    if not hasattr(RDG, "calls"):
        return {}
    return {"drct_rdg_calls": RDG.calls, "drct_masked_attn_calls": RDG.masked_attn_calls}


def expected_counters(cfg: dict, chunks: int) -> dict:
    """Per chunk: one RDG forward per group, and in each the shift mask in
    the blocks that shift (2 and 4)."""
    groups = len(cfg["num_heads"])
    shifted = sum(sum(1 for b in reference.blocks(cfg, h) if b[3]) for h in cfg["num_heads"])
    return {"drct_rdg_calls": groups * chunks, "drct_masked_attn_calls": shifted * chunks}
