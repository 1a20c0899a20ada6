"""The comparison that decides `correct`: outputs of calls from the timed
window against the plain reference, on the same pool images.

Numbers, each per image and the worst image reported; a cell compares
those its `[check]` table gives a limit:

* `pred_rel_rms`: RMS of the prediction's gap over the RMS of the
  reference's prediction (the flux products, relative);
* `pred_max`: the widest gap of the prediction on the model's output
  scale, sqrt(pred / hr_max) in [0, 1] (the clipped model output);
* `input_max`: the widest gap of the denormalized input half, over lr_max.

A number passes when it is not above its limit; NaN fails.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

NUMBERS = ("pred_rel_rms", "pred_max", "input_max")


@contextmanager
def exact_f32():
    """float32 matrix products and convolutions without TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gaps(pred, inp, ref_pred, ref_inp, cfg: dict) -> dict:
    """The numbers for one image's two halves (host arrays)."""
    p = np.asarray(pred, np.float64) / cfg["hr_max"]
    r = np.asarray(ref_pred, np.float64) / cfg["hr_max"]
    rel = np.sqrt(np.mean((p - r) ** 2) / max(np.mean(r * r), 1e-300))
    di = (np.asarray(inp, np.float64) - np.asarray(ref_inp, np.float64)) / cfg["lr_max"]
    return {"pred_rel_rms": float(rel), "pred_max": float(np.abs(np.sqrt(p) - np.sqrt(r)).max()),
            "input_max": float(np.abs(di).max())}


def worst(per_image: list) -> dict:
    """The largest of each number over images; NaN if any is NaN, or if
    there is no image to compare (every call of the window failed)."""
    return {k: float(max((g[k] for g in per_image), key=lambda v: (np.isnan(v), v),
                         default=np.nan)) for k in NUMBERS}


def compare(kept: list, pool: np.ndarray, ref_serve, block: int, cfg: dict, device) -> dict:
    """Run `ref_serve(rates on device) -> (pred, inp)` over the kept
    outputs' pool images, `block` images at a time, and return the worst
    of each number."""
    per_image = []
    with torch.inference_mode(), exact_f32():
        for s in range(0, len(kept), block):
            part = kept[s : s + block]
            rates = torch.from_numpy(np.stack([pool[i] for i, _, _ in part])).to(device)
            rp, ri = (t.cpu().numpy() for t in ref_serve(rates))
            for j, (_, p, x) in enumerate(part):
                per_image.append(gaps(p, x, rp[j], ri[j], cfg))
    return worst(per_image)


def verdict(numbers: dict, limits: dict) -> tuple:
    """{name: {"value", "limit"}} of the numbers that have a limit, and
    whether every one of them passed."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    return out, all(v["value"] <= v["limit"] for v in out.values())
