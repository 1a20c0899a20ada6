"""What the port's training tests share: the small esr_gen/rrdb_denoise
configurations in both packages' schemas, a seeded batch, and the Flax init
converted to the port's state_dict."""

import importlib
from pathlib import Path

import jax
import numpy as np
import torch

from xmm_superres_denoise_torch import config as tcfg
from xmm_superres_denoise_torch.utils.weights import params_from_flax

jcfg = importlib.import_module("xmm_superres_denoise_tpu.config")

ROOT = Path(__file__).resolve().parents[1]
# the run config's stretch (sqrt) with its scaling table; MS-SSIM needs 208
# px, so the fast tests weigh l1, psnr and ssim instead of psnr + ms_ssim
LOSS_WEIGHTS = dict(l1=0.3, poisson=0.0, psnr=0.4, ssim=0.3, ms_ssim=0.0)
SQRT_TABLE = __import__("tomllib").loads(
    (ROOT / "res/configs/loss_functions.toml").read_text())["scaling"]["sqrt"]


def configs(mod, tmp_path, *, lr_res=32, batch=8, name="esr_gen", filters=4, blocks=1,
            s2d_train=False, memory_efficient=False, lr=1e-4, **trainer):
    """(DatasetCfg, ModelCfg, TrainerCfg) of `mod` (the port's or JAX's
    config package) for a boring dataset at lr_res -> 2 * lr_res."""
    hr_res = lr_res * (2 if name == "esr_gen" else 1)
    ds = mod.DatasetCfg(
        agn=0, batch_size=batch, check_files=False, debug=True, comb_hr=False,
        crop_mode="center", directory=tmp_path, mode="img", name="boring_test",
        scaling="sqrt", type="boring",
        lr=mod.LrDatasetCfg(bkg=0, exps=[20], clamp_max=0.0022336, res=lr_res),
        hr=mod.HrDatasetCfg(exp=100, clamp_max=0.0005584 if name == "esr_gen" else 0.0022336,
                            res=hr_res),
    )
    mc = mod.ModelCfg(
        name=name, memory_efficient=memory_efficient, batch_size=batch, s2d_train=s2d_train,
        model=mod.RrdbCfg(base_model=name, in_channels=1, out_channels=1, filters=filters,
                          residual_blocks=blocks),
        optimizer=mod.OptimizerCfg(learning_rate=lr, betas=(0.9, 0.999)),
    )
    trainer.setdefault("epochs", 2)
    trainer.setdefault("checkpoint_root", tmp_path / "ckpt")
    trainer.setdefault("mesh", mod.MeshCfg(data="auto", fsdp=1))
    return ds, mc, mod.TrainerCfg(**trainer)


def batch(seed=0, b=2, lr_res=32, scale=2, weights=None):
    """A smooth scene at LR and its noisy HR counterpart, as numpy."""
    g = np.random.default_rng(seed)
    coarse = g.uniform(0.05, 0.9, (b, lr_res // 8, lr_res // 8, 1))
    hr = np.repeat(np.repeat(coarse, 8 * scale, axis=1), 8 * scale, axis=2)
    hr = np.clip(hr + 0.03 * g.normal(size=hr.shape), 0.01, 1).astype(np.float32)
    lr = np.clip(hr[:, ::scale, ::scale] + 0.05 * g.normal(size=(b, lr_res, lr_res, 1)), 0, 1)
    out = {"lr": lr.astype(np.float32), "hr": hr}
    if weights is not None:
        out["weight"] = np.asarray(weights, np.float32)
    return out


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def state_dict_of(jax_params):
    """The port's state_dict of a Flax params tree."""
    return params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))


__all__ = ["LOSS_WEIGHTS", "SQRT_TABLE", "batch", "configs", "jcfg", "state_dict_of", "tcfg",
           "to_torch"]
