"""Image-geometry ops the serving engine calls, on tensors.

The port of `pad_to_res`, `crop_fractions` and `crop` from
the JAX package's `ops/preprocess.py`. Helpers act on the trailing
(H, W) dims of (..., H, W) tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Native XMM EPIC-pn detector-coordinate image geometry at bin 80 (4"/px):
# NAXIS1=403 (x), NAXIS2=411 (y) -> numpy shape (411, 403).
NATIVE_HW: Tuple[int, int] = (411, 403)


def pad_to_res(img: torch.Tensor, res: int) -> torch.Tensor:
    """Center zero-pad the trailing (H, W) dims to (res, res); the top/left
    pad gets floor(diff/2)."""
    h, w = img.shape[-2], img.shape[-1]
    y_diff = res - h
    x_diff = res - w
    if y_diff < 0 or x_diff < 0:
        raise ValueError(f"pad_to_res only pads; got {h}x{w} -> {res}")
    y_top = y_diff // 2
    x_left = x_diff // 2
    # F.pad orders (left, right, top, bottom) for the last two dims
    return F.pad(img, (x_left, x_diff - x_left, y_top, y_diff - y_top))


def crop_fractions(
    mode: str,
    crop_p: float,
    native_hw: Tuple[int, int] = NATIVE_HW,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[float, float]:
    """(top_p, left_p) crop-origin fractions per crop mode. `boresight`
    centres on detector pixel (y=224, x=244) of the native (411, 403) image."""
    if mode == "random":
        rng = rng or np.random.default_rng()
        return (
            float(rng.uniform(0.0, 1.0 - crop_p)),
            float(rng.uniform(0.0, 1.0 - crop_p)),
        )
    if mode == "center":
        return ((1.0 - crop_p) / 2.0,) * 2
    if mode == "boresight":
        h, w = native_hw
        return (224.0 / h - 0.5 * crop_p, 244.0 / w - 0.5 * crop_p)
    raise ValueError(f"Unknown crop mode {mode!r}")


def crop(img: torch.Tensor, crop_p: float, top_p: float, left_p: float) -> torch.Tensor:
    """Crop trailing (H, W) to a crop_p fraction, origin at (top_p, left_p),
    clamped so the window stays inside the image."""
    if crop_p == 1.0:
        return img
    h, w = img.shape[-2], img.shape[-1]
    h_res, w_res = int(h * crop_p), int(w * crop_p)
    top = min(int(top_p * h), h - h_res)
    left = min(int(left_p * w), w - w_res)
    return img[..., top : top + h_res, left : left + w_res]
