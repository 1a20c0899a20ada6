"""Epoch image logging: input/prediction/target/difference/SSIM-map panels.

The port of the JAX package's `utils/imagelogger.py` (the reference's W&B
ImageLogger callback, rebuilt on the clean (lr, hr) batch schema):

  * renders a panel per display sample: input / generated / label /
    difference / SSIM map, plasma colormap for images, seismic for the
    difference;
  * writes the panels as PNG and exposure-multiplied FITS per image
    (`io/wcs.py: write_xmm_product`);
  * forwards to Weights & Biases when the `wandb` package is importable
    and a run is active (import-guarded).

matplotlib is imported when a panel is drawn. Without it the PNG is
skipped with a warning and the FITS are written all the same. The SSIM map
runs in torch on the logger's `device` (the trainer's).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..io.wcs import write_xmm_product
from ..ops.ssim import _depthwise_blur, _reflect_pad, gaussian_kernel_1d
from ..ops.stretch import Normalizer

log = logging.getLogger("xmmsr")


def _try_wandb():
    try:
        import wandb  # noqa: F401

        if wandb.run is not None:
            return wandb
    except Exception:
        pass
    return None


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class ImageLogger:
    """Renders and persists display panels every `log_every_n_epochs`."""

    def __init__(
        self,
        out_dir: Path,
        normalizer: Normalizer,
        log_every_n_epochs: int = 1,
        lr_exp_ks: float = 20.0,
        hr_exp_ks: float = 100.0,
        device: Union[str, torch.device] = "cpu",
    ):
        self.out_dir = Path(out_dir)
        self.normalizer = normalizer
        self.every = max(1, log_every_n_epochs)
        self.lr_exp = lr_exp_ks * 1000.0
        self.hr_exp = hr_exp_ks * 1000.0
        self.device = torch.device(device)

    def should_log(self, epoch: int) -> bool:
        return epoch % self.every == 0

    def log_batch(
        self,
        epoch: int,
        lr: np.ndarray,  # (B, H, W, 1) normalized
        preds: np.ndarray,  # (B, H', W', 1) normalized
        hr: Optional[np.ndarray] = None,
        max_images: int = 4,
    ) -> Optional[Path]:
        """Write the epoch's panel PNG and FITS under `epoch_<epoch>/`;
        returns the PNG's path (None off the epoch grid, or without
        matplotlib)."""
        if not self.should_log(epoch):
            return None
        out = self.out_dir / f"epoch_{epoch:05d}"
        out.mkdir(parents=True, exist_ok=True)
        n = min(max_images, preds.shape[0])

        panel_path = None
        plt = _pyplot()
        if plt is None:
            log.warning("image logger: matplotlib is not installed; the display panel PNG of "
                        "epoch %d is not drawn (its FITS are written)", epoch)
        else:
            panel_path = self._draw(plt, out / "display.png", n, lr, preds, hr)

        for i in range(n):
            den_in = self._denorm(self.normalizer.denormalize_lr, lr[i, ..., 0]) * self.lr_exp
            den_pred = self._denorm(self.normalizer.denormalize_hr, preds[i, ..., 0]) * self.hr_exp
            res_mult = den_pred.shape[0] // den_in.shape[0]
            write_xmm_product(den_in, out, f"display_{i}_input", 1, self.lr_exp)
            write_xmm_product(den_pred, out, f"display_{i}_generated", res_mult, self.hr_exp)

        wandb = _try_wandb()
        if wandb is not None and panel_path is not None:
            wandb.log({"images/display": wandb.Image(str(panel_path))}, step=epoch)

        log.info("Logged %d display images to %s", n, out)
        return panel_path

    @staticmethod
    def _denorm(fn, img: np.ndarray) -> np.ndarray:
        return fn(torch.from_numpy(np.asarray(img, np.float32))).numpy()

    def _draw(self, plt, panel_path: Path, n: int, lr, preds, hr) -> Path:
        cols = ["input", "generated"]
        if hr is not None:
            cols += ["label", "difference", "ssim"]
        fig, axes = plt.subplots(n, len(cols), figsize=(3 * len(cols), 3 * n), squeeze=False)
        for i in range(n):
            panels: Dict[str, np.ndarray] = {
                "input": lr[i, ..., 0],
                "generated": preds[i, ..., 0],
            }
            if hr is not None:
                panels["label"] = hr[i, ..., 0]
                panels["difference"] = preds[i, ..., 0] - hr[i, ..., 0]
                # per-pixel SSIM map at the reference kernel config
                panels["ssim"] = _ssim_map(preds[i : i + 1], hr[i : i + 1], self.device)
            for j, name in enumerate(cols):
                img = panels[name]
                ax = axes[i][j]
                if name == "difference":
                    v = float(np.abs(img).max()) or 1.0
                    ax.imshow(img, cmap="seismic", vmin=-v, vmax=v, origin="lower")
                else:
                    ax.imshow(img, cmap="plasma", origin="lower")
                ax.set_title(name if i == 0 else "")
                ax.axis("off")
        fig.tight_layout()
        fig.savefig(panel_path, dpi=100)
        plt.close(fig)
        return panel_path


def _ssim_map(pred: np.ndarray, target: np.ndarray,
              device: Union[str, torch.device] = "cpu") -> np.ndarray:
    """The SSIM map of one (1, H, W, 1) pair over the reflect-padded
    image, (H, W), computed on `device`."""
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    t = torch.as_tensor(np.asarray(target, np.float32), device=device)
    taps = torch.as_tensor(gaussian_kernel_1d(), device=device)
    pad = 13 // 2
    pp = _reflect_pad(p, pad)
    tt = _reflect_pad(t, pad)
    mu_p = _depthwise_blur(pp, taps)
    mu_t = _depthwise_blur(tt, taps)
    s_p = _depthwise_blur(pp * pp, taps) - mu_p**2
    s_t = _depthwise_blur(tt * tt, taps) - mu_t**2
    s_pt = _depthwise_blur(pp * tt, taps) - mu_p * mu_t
    c1, c2 = 0.01**2, 0.05**2
    m = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / (
        (mu_p**2 + mu_t**2 + c1) * (s_p + s_t + c2)
    )
    return m[0, ..., 0].cpu().numpy()
