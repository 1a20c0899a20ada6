"""Frozen plain reference of the esr_gen SR pipeline (RRDB generator).

Plain `torch` in float32 with TF32 off, NCHW, written from the
architecture (Wang et al. 2018, ESRGAN; Sweere et al. 2022) and the
serving pipeline, not from the program: it imports nothing of the port.

    rate (B, 411, 403) -> centre zero-pad to lr_res -> clamp[0, lr_max] /
    lr_max -> sqrt -> clamp[0, 1] -> generator -> clamp[0, 1] -> square *
    hr_max -> clamp[0, hr_max]                           (prediction)
    normalized input -> square * lr_max -> clamp[0, lr_max]  (input half)

Generator: conv_first -> n x RRDB (3 dense blocks of 5 convs, dense
concatenation, LeakyReLU 0.2 after convs 1-4, out * 0.2 + x; RRDB out *
0.2 + x) -> trunk_conv, long skip -> [conv nf -> 4nf, LeakyReLU 0.01,
pixel shuffle 2] x n_up -> HRconv, LeakyReLU 0.2 -> conv_last -> clamp.

Weights come from the Flax checkpoint (`params/...` keys, HWIO kernels),
read here from the npz itself.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def load_flax_npz(path: Path, device) -> Dict[str, Tensor]:
    """The checkpoint's arrays keyed without the `params/` root, kernels
    HWIO -> OIHW, float32 on `device`."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            arr = np.asarray(z[key], np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            out[key.split("/", 1)[1]] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def _conv(w: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    return F.conv2d(x, w[f"{name}/kernel"], padding=1) + w[f"{name}/bias"][:, None, None]


def generator(w: Dict[str, Tensor], x: Tensor, n_rrdb: int, n_up: int) -> Tensor:
    """NCHW float32 normalized input -> NCHW output in [0, 1]."""
    fea = _conv(w, "trunk/conv_first", x)
    t = fea
    for i in range(n_rrdb):
        r_in = t
        for j in (1, 2, 3):
            pre = f"trunk/rrdb_{i}/RDB{j}"
            feats = [t]
            for k in range(1, 5):
                feats.append(F.leaky_relu(_conv(w, f"{pre}/conv{k}", torch.cat(feats, 1)), 0.2))
            t = _conv(w, f"{pre}/conv5", torch.cat(feats, 1)) * 0.2 + t
        t = t * 0.2 + r_in
    fea = fea + _conv(w, "trunk/trunk_conv", t)
    for i in range(n_up):
        fea = F.pixel_shuffle(F.leaky_relu(_conv(w, f"upconv_{i}", fea), 0.01), 2)
    fea = F.leaky_relu(_conv(w, "HRconv", fea), 0.2)
    return torch.clamp(_conv(w, "conv_last", fea), 0.0, 1.0)


def pad_to(img: Tensor, res: int) -> Tensor:
    """Centre zero-pad (..., H, W) to (res, res); the top and left get the
    floor of half the difference."""
    h, w = img.shape[-2:]
    top, left = (res - h) // 2, (res - w) // 2
    return F.pad(img, (left, res - w - left, top, res - h - top))


def normalize(x: Tensor, vmax: float) -> Tensor:
    return torch.clamp(torch.sqrt(torch.clamp(x, 0.0, vmax) / vmax), 0.0, 1.0)


def denormalize(x: Tensor, vmax: float) -> Tensor:
    return torch.clamp(torch.square(x) * vmax, 0.0, vmax)


def prepare(rates: Tensor, cfg: dict, dtype=torch.float32) -> tuple:
    """(B, H, W) rates -> (normalized (B, lr, lr), denormalized input half
    float32), in `dtype` (float32 as configured; bfloat16 for the control)."""
    x = normalize(pad_to(rates.to(dtype), cfg["lr_res"]), cfg["lr_max"])
    return x, denormalize(x, cfg["lr_max"]).float()


def finish(y: Tensor, cfg: dict, dtype=torch.float32) -> Tensor:
    """Raw model output (B, hr, hr) -> clip -> denormalized prediction."""
    return denormalize(torch.clamp(y, 0.0, 1.0).to(dtype), cfg["hr_max"]).float()


def serve(w: Dict[str, Tensor], rates: Tensor, cfg: dict) -> tuple:
    """(B, H, W) rates on the device -> (prediction (B, hr, hr), input
    half (B, lr, lr)), float32."""
    x, inp = prepare(rates, cfg)
    y = generator(w, x[:, None], cfg["residual_blocks"], cfg["upsample"])
    return finish(y[:, 0], cfg), inp


def checked_path(cfg: dict, root: Path) -> Path:
    """The configuration's checkpoint, refused unless it has its digest."""
    path = Path(root) / cfg["weights"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfg["weights_sha256"]:
        raise RuntimeError(f"{path}: sha256 {digest}, the configuration states "
                           f"{cfg['weights_sha256']}")
    return path


def weights(cfg: dict, seed: int, root: Path, device) -> Dict[str, Tensor]:
    """The reference's own float32 weights, read from the checkpoint."""
    return load_flax_npz(checked_path(cfg, root), device)
