"""The composite weighted metric loss with per-stretch affine scaling.

The port of the JAX package's `train/loss.py`:

    loss(preds, target) = sum_i  p_i * scaling_i * metric_i(preds, target)
                          + sum_i correction_i        (over the included terms)

with metric_i in {l1, poisson, psnr, ssim, ms_ssim}, p_i the `LossCfg`
weights and scaling/correction from the per-stretch tables of
`res/configs/loss_functions.toml` (the paper's calibration, unchanged). The
accumulated correction is added only when it is positive, as the reference
adds it. The returned callable is a torch function of (preds, target),
differentiable by autograd.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import Tensor

from ..config.schema import LossCfg
from ..metrics.functional import l1, ms_ssim, poisson_nll, psnr, ssim

LossFn = Callable[[Tensor, Tensor], Tensor]

_TERMS: Dict[str, LossFn] = {
    "l1": l1,
    "poisson": poisson_nll,
    "psnr": psnr,
    "ssim": ssim,
    "ms_ssim": ms_ssim,
}


def create_loss(
    sc_dict: Optional[Dict[str, Dict[str, float]]],
    loss_config: LossCfg,
) -> LossFn:
    """Build the weighted composite loss. `sc_dict` is the stretch's
    `{metric: {scaling, correction}}` table, or None for no scaling. Terms of
    weight 0 are dropped here, so the loss computes only what it needs; the
    callable carries `.terms` [(name, weight, metric)] and `.correction`."""
    weights = {
        "l1": loss_config.l1,
        "poisson": loss_config.poisson,
        "psnr": loss_config.psnr,
        "ssim": loss_config.ssim,
        "ms_ssim": loss_config.ms_ssim,
    }

    terms = []
    correction = 0.0
    for name, p in weights.items():
        if p <= 0.0:
            continue
        if sc_dict is not None and name in sc_dict:
            p = p * sc_dict[name]["scaling"]
            correction += sc_dict[name]["correction"]
        terms.append((name, p, _TERMS[name]))

    if not terms:
        raise ValueError("Loss config selected no terms")
    corr = correction if correction > 0.0 else 0.0

    def loss_fn(preds: Tensor, target: Tensor) -> Tensor:
        total = torch.tensor(corr, dtype=preds.dtype, device=preds.device)
        for _, p, fn in terms:
            total = total + p * fn(preds, target)
        return total

    loss_fn.terms = terms
    loss_fn.correction = corr
    return loss_fn


def load_scaling_tables(loss_toml: dict, stretch_mode: str):
    """(sc_dict, LossCfg) from a parsed loss_functions.toml: `use_scaling`
    gates the lookup of the stretch's table."""
    cfg = dict(loss_toml["loss"])
    sc_dict = None
    if cfg.pop("use_scaling"):
        sc_dict = loss_toml["scaling"][stretch_mode]
    return sc_dict, LossCfg(**cfg)
