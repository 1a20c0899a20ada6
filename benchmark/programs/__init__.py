"""The system under test, one module per model family: each builds the
port's `InferenceEngine` for a configuration of `configs/` (and, where
the port has a lower-precision path of its own, the control's engine).
These are the only modules of the benchmark that import the port."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dataset_config(cfg: dict):
    """The port's DatasetCfg for a configuration's pipeline numbers."""
    from xmm_superres_denoise_torch.config import DatasetCfg, HrDatasetCfg, LrDatasetCfg

    return DatasetCfg(
        lr=LrDatasetCfg(exps=[cfg["lr_exp_ks"]], clamp_max=cfg["lr_max"], res=cfg["lr_res"]),
        hr=HrDatasetCfg(exp=cfg["hr_exp_ks"], clamp_max=cfg["hr_max"], res=cfg["hr_res"]),
        scaling=cfg["scaling"], batch_size=cfg["batch_size"],
    )
