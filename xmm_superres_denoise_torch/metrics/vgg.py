"""VGG perceptual feature loss (the reference's VGGLoss, metrics/metrics.py:104-150).

The port of the JAX package's `metrics/vgg.py`. The reference wraps
torchvision's VGG features (the first `layers + 1` modules of vgg11/13/16/19,
ImageNet-normalized inputs, MSE over the feature maps) and never uses it in
the training path; neither package calls it.

  * `VGGFeatures`: the convolutional prefix of a VGG network on NHWC
    input, its modules under `features.N` as torchvision numbers them, so a
    torchvision state dict's `features.N.weight` / `features.N.bias` load
    directly (`load_state_dict(..., strict=False)` for a whole VGG's);
  * `VGGLoss`: grayscale -> 3 channels, ImageNet mean/std normalization,
    MSE between feature maps;
  * `load_vgg_params_npz`: the npz that `scripts/export_vgg_npz.py` writes
    (torchvision keys, OIHW) -> a `VGGFeatures`.

No weights are downloaded. With random weights (seeded) the loss is a
random-projection perceptual distance; it matches the reference only with
the pretrained ImageNet weights. `utils/weights.py: vgg_state_from_flax`
carries the JAX package's Flax VGG tree across.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import true_f32

# torchvision VGG configs: numbers = conv output channels, "M" = maxpool.
VGG_CONFIGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (
        64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M",
    ),
    "vgg19": (
        64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
    ),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _torchvision_modules(config) -> list:
    """The flat nn.Sequential module list torchvision builds: every conv is
    followed by a ReLU module (relevant for the `layers` cutoff index)."""
    mods = []
    for c in config:
        if c == "M":
            mods.append(("pool", None))
        else:
            mods.append(("conv", c))
            mods.append(("relu", None))
    return mods


class VGGFeatures(nn.Module):
    """features[: layers + 1] of a torchvision VGG; NHWC in and out."""

    def __init__(self, vgg_model: str = "vgg19", layers: int = 8):
        super().__init__()
        self.vgg_model, self.layers = vgg_model, layers
        mods, cin = [], 3
        for kind, c in _torchvision_modules(VGG_CONFIGS[vgg_model])[: layers + 1]:
            if kind == "conv":
                mods.append(nn.Conv2d(cin, c, 3, padding=1))
                cin = c
            elif kind == "relu":
                mods.append(nn.ReLU())
            else:
                mods.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*mods)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's default Conv init, drawn from `generator`: LeCun-normal
        kernels (fan-in, truncated at 2 sigma) and zero biases."""
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                std = (1.0 / (m.in_channels * 9)) ** 0.5 / 0.87962566103423978
                with torch.no_grad():
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with true_f32():
            return self.features(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class VGGLoss(nn.Module):
    """MSE between VGG feature maps of preds and target (metrics.py:139-150).
    `params`: a state_dict of `VGGFeatures`; None draws one from `seed`."""

    def __init__(self, vgg_model: str = "vgg19", layers: int = 8,
                 params: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0):
        super().__init__()
        self.net = VGGFeatures(vgg_model, layers)
        if params is None:
            self.net.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            self.net.load_state_dict(params)
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD), persistent=False)

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        return (x - self.mean) / self.std

    def forward(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        fp = self.net(self._prep(preds))
        ft = self.net(self._prep(target))
        return F.mse_loss(fp, ft)


def load_vgg_params_npz(path: Union[str, Path], vgg_model: str = "vgg19",
                        layers: int = 8) -> VGGFeatures:
    """A torchvision VGG state dict exported as npz (`features.N.weight` /
    `features.N.bias`, OIHW) -> `VGGFeatures` holding its first `layers + 1`
    modules' weights."""
    net = VGGFeatures(vgg_model, layers)
    want = net.state_dict()
    with np.load(path) as data:
        state = {k: torch.from_numpy(np.asarray(data[k], np.float32)) for k in want}
    net.load_state_dict(state)
    return net
