"""Differentiable image-quality metrics (the core suite) on NHWC tensors.

The port of the JAX package's `metrics/functional.py`: PSNR, SSIM, MS-SSIM,
L1, L2 and the Poisson NLL of the reference's torchmetrics-backed core suite.
Each takes (preds, target) as NHWC float tensors and returns a scalar, batch
reduced as the torchmetrics metric reduces. `data_range` defaults to 1.0:
the images are clamped to [0, 1].
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..ops.ssim import ms_ssim_per_image, ssim_per_image


def _abs(x: Tensor) -> Tensor:
    """|x| with JAX's derivative: +1 at x == 0, where `torch.abs`'s is 0
    (pixels the clamp puts at the same bound in both images)."""
    return torch.where(x >= 0, x, -x)


def l1(preds: Tensor, target: Tensor) -> Tensor:
    """Mean absolute error over all elements."""
    return torch.mean(_abs(preds - target))


def l2(preds: Tensor, target: Tensor) -> Tensor:
    """Mean squared error over all elements."""
    return torch.mean(torch.square(preds - target))


def psnr(preds: Tensor, target: Tensor, data_range: float = 1.0) -> Tensor:
    """Peak signal-to-noise ratio, 10 * log10(range^2 / mse)."""
    mse = torch.mean(torch.square(preds - target))
    return 10.0 * torch.log10(data_range**2 / mse)


def poisson_nll(preds: Tensor, target: Tensor, eps: float = 1e-8) -> Tensor:
    """`F.poisson_nll_loss(log_input=False, full=False)`: the mean of
    preds - target * log(preds + eps)."""
    return torch.mean(preds - target * torch.log(preds + eps))


def ssim(
    preds: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    kernel_size: int = 13,
    sigma: float = 2.5,
    k1: float = 0.01,
    k2: float = 0.05,
) -> Tensor:
    """Batch-mean SSIM with the reference's kernel configuration."""
    return torch.mean(ssim_per_image(
        preds, target, data_range, kernel_size=kernel_size, sigma=sigma, k1=k1, k2=k2
    ))


def ms_ssim(
    preds: Tensor,
    target: Tensor,
    data_range: float = 1.0,
    kernel_size: int = 13,
    sigma: float = 2.5,
    k1: float = 0.01,
    k2: float = 0.05,
) -> Tensor:
    """Batch-mean multi-scale SSIM with the reference's kernel configuration."""
    return torch.mean(ms_ssim_per_image(
        preds, target, data_range, kernel_size=kernel_size, sigma=sigma, k1=k1, k2=k2
    ))


CORE_METRICS = {
    "psnr": psnr,
    "ssim": ssim,
    "ms_ssim": ms_ssim,
    "l1": l1,
    "l2": l2,
    "poisson": poisson_nll,
}
