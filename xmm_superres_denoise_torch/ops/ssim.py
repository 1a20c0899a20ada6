"""SSIM and MS-SSIM on NHWC images through depthwise convolutions.

The port of the JAX package's `ops/ssim.py`, which follows torchmetrics'
StructuralSimilarityIndexMeasure / MultiScaleStructuralSimilarityIndexMeasure
as the reference configures them (kernel 13, sigma 2.5, k2 0.05):

  * a normalized 13-tap Gaussian, applied separably: one depthwise pass over
    H, then one over W (`F.conv2d` with `groups=C`), as JAX does; one 13x13
    kernel would sum in another order;
  * reflect padding by k // 2, VALID convolutions, then k // 2 cropped off
    each side: the mean is over the interior;
  * MS-SSIM: 5 scales, betas (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), 2x2
    average pooling between scales, ReLU on the contrast sensitivities,
    product of stack ** betas.

Every function is plain PyTorch, differentiable by autograd. The blurs run
under `true_f32`: cuDNN would otherwise run f32 convolutions in TF32 on a
card, where JAX asks for `Precision.HIGHEST`.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from .precision import true_f32

MS_SSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def gaussian_kernel_1d(kernel_size: int = 13, sigma: float = 2.5) -> np.ndarray:
    """Normalized 1-D Gaussian taps (torchmetrics' `_gaussian`), float32."""
    half = kernel_size // 2
    x = np.arange(-half, -half + kernel_size, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_blur(x: Tensor, taps: Tensor) -> Tensor:
    """Separable depthwise Gaussian filter, VALID. x: (N, H, W, C)."""
    c, k = x.shape[-1], taps.shape[0]
    kh = taps.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = taps.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    y = x.permute(0, 3, 1, 2)
    with true_f32():
        y = F.conv2d(y, kh, groups=c)
        y = F.conv2d(y, kw, groups=c)
    return y.permute(0, 2, 3, 1)


def _reflect_pad(x: Tensor, pad: int) -> Tensor:
    """Reflect-pad the H and W dims of an NHWC tensor (edge not repeated)."""
    return F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect").permute(0, 2, 3, 1)


def ssim_per_image(
    preds: Tensor,
    target: Tensor,
    data_range: Union[float, Tensor] = 1.0,
    *,
    kernel_size: int = 13,
    sigma: float = 2.5,
    k1: float = 0.01,
    k2: float = 0.05,
    return_cs: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Per-image SSIM, shape (N,), of NHWC inputs; with `return_cs` also the
    contrast sensitivity. torchmetrics' `_ssim_update`: reflect pad ->
    Gaussian blur (VALID) -> crop the pad -> interior mean."""
    taps = torch.from_numpy(gaussian_kernel_1d(kernel_size, sigma)).to(preds.device, preds.dtype)
    pad = kernel_size // 2

    p = _reflect_pad(preds, pad)
    t = _reflect_pad(target, pad)

    mu_p = _depthwise_blur(p, taps)
    mu_t = _depthwise_blur(t, taps)
    mu_pp = _depthwise_blur(p * p, taps)
    mu_tt = _depthwise_blur(t * t, taps)
    mu_pt = _depthwise_blur(p * t, taps)

    mu_p_sq = mu_p * mu_p
    mu_t_sq = mu_t * mu_t
    sigma_p = mu_pp - mu_p_sq
    sigma_t = mu_tt - mu_t_sq
    sigma_pt = mu_pt - mu_p * mu_t

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    upper = 2.0 * sigma_pt + c2
    lower = sigma_p + sigma_t + c2
    ssim_map = ((2.0 * mu_p * mu_t + c1) * upper) / ((mu_p_sq + mu_t_sq + c1) * lower)

    # crop k // 2 off each side (torchmetrics crops the padded border)
    ssim_map = ssim_map[:, pad:-pad, pad:-pad, :]
    ssim = ssim_map.reshape(ssim_map.shape[0], -1).mean(dim=-1)
    if not return_cs:
        return ssim
    cs_map = (upper / lower)[:, pad:-pad, pad:-pad, :]
    return ssim, cs_map.reshape(cs_map.shape[0], -1).mean(dim=-1)


def _avg_pool_2x2(x: Tensor) -> Tensor:
    n, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2, :]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def ms_ssim_per_image(
    preds: Tensor,
    target: Tensor,
    data_range: Union[float, Tensor] = 1.0,
    *,
    kernel_size: int = 13,
    sigma: float = 2.5,
    k1: float = 0.01,
    k2: float = 0.05,
    normalize: str = "relu",
) -> Tensor:
    """Per-image multi-scale SSIM, shape (N,), torchmetrics semantics. Each
    side must be at least kernel_size * 16 px (five halving scales).

    A contrast term at or below 0 gives a zero base under a fractional
    exponent; its gradient is 0, as under `jax.grad`, because ReLU's
    backward selects 0 there whatever the power's backward gives."""
    min_side = min(preds.shape[1], preds.shape[2])
    needed = kernel_size * 2 ** (len(MS_SSIM_BETAS) - 1)
    if min_side < needed:
        raise ValueError(
            f"MS-SSIM with kernel {kernel_size} needs images >= {needed} px per "
            f"side (5 halving scales); got {preds.shape[1]}x{preds.shape[2]}"
        )
    betas = torch.tensor(MS_SSIM_BETAS, dtype=preds.dtype, device=preds.device)
    mcs = []
    sim = None
    p, t = preds, target
    for i in range(len(MS_SSIM_BETAS)):
        sim, cs = ssim_per_image(
            p, t, data_range, kernel_size=kernel_size, sigma=sigma, k1=k1, k2=k2,
            return_cs=True,
        )
        mcs.append(cs)
        if i < len(MS_SSIM_BETAS) - 1:
            p = _avg_pool_2x2(p)
            t = _avg_pool_2x2(t)
    mcs[-1] = sim
    stack = torch.stack(mcs)  # (scales, N)
    if normalize == "relu":
        stack = torch.relu(stack)
    return torch.prod(stack ** betas[:, None], dim=0)
