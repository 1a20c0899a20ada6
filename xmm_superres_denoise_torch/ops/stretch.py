"""Intensity stretches and normalization on tensors.

The port of the JAX package's `ops/stretch.py`: the same four
stretch modes with the same constants, and the same clamp -> divide ->
stretch -> clamp chain, as plain tensor functions.

Stretch modes and their exact constants:
  * linear : identity
  * sqrt   : sqrt / square
  * log    : DS9-style log a=1000,  log(a*x+1)/log(a)
  * asinh  : a=0.02, asinh(x/a)/asinh(1/a)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

Tensor = torch.Tensor

_ASINH_A = 0.02
_LOG_A = 1000.0
# the JAX package divides by float32 asinh(1/a); keep the same constant
_ASINH_NORM = float(torch.asinh(torch.tensor(1.0 / _ASINH_A, dtype=torch.float32)))


def _stretch_linear(x: Tensor) -> Tensor:
    return x


def _stretch_sqrt(x: Tensor) -> Tensor:
    return torch.sqrt(x)


def _destretch_sqrt(x: Tensor) -> Tensor:
    return torch.square(x)


def _stretch_log(x: Tensor) -> Tensor:
    return torch.log(_LOG_A * x + 1.0) / math.log(_LOG_A)


def _destretch_log(x: Tensor) -> Tensor:
    return (torch.pow(_LOG_A, x) - 1.0) / _LOG_A


def _stretch_asinh(x: Tensor) -> Tensor:
    return torch.asinh(x / _ASINH_A) / _ASINH_NORM


def _destretch_asinh(x: Tensor) -> Tensor:
    return _ASINH_A * torch.sinh(x * _ASINH_NORM)


STRETCH_FNS: Dict[str, Tuple[Callable[[Tensor], Tensor], Callable[[Tensor], Tensor]]] = {
    "linear": (_stretch_linear, _stretch_linear),
    "sqrt": (_stretch_sqrt, _destretch_sqrt),
    "log": (_stretch_log, _destretch_log),
    "asinh": (_stretch_asinh, _destretch_asinh),
}

STRETCH_MODES = tuple(STRETCH_FNS)


def _fns(mode: str):
    try:
        return STRETCH_FNS[mode]
    except KeyError:
        raise ValueError(f"Unknown stretch mode {mode!r}; options: {STRETCH_MODES}")


def stretch(x: Tensor, mode: str) -> Tensor:
    """Apply the named stretch to an already [0,1]-normalized image."""
    return _fns(mode)[0](x)


def destretch(x: Tensor, mode: str) -> Tensor:
    return _fns(mode)[1](x)


def normalize(x: Tensor, max_val: float, mode: str = "linear") -> Tensor:
    """clamp[0,max] -> /max -> stretch -> clamp[0,1] (max_val > 0)."""
    x = torch.clamp(x, 0.0, max_val) / max_val
    return torch.clamp(stretch(x, mode), 0.0, 1.0)


def denormalize(x: Tensor, max_val: float, mode: str = "linear") -> Tensor:
    """Inverse of :func:`normalize`: destretch -> *max -> clamp[0,max]."""
    return torch.clamp(destretch(x, mode) * max_val, 0.0, max_val)


@dataclass(frozen=True)
class Normalizer:
    """Paired lr/hr normalization spec: the clamp maxima from the dataset
    config and the stretch mode."""

    lr_max: float
    hr_max: float
    mode: str = "linear"

    def normalize_lr(self, x: Tensor) -> Tensor:
        return normalize(x, self.lr_max, self.mode)

    def normalize_hr(self, x: Tensor) -> Tensor:
        return normalize(x, self.hr_max, self.mode)

    def denormalize_lr(self, x: Tensor) -> Tensor:
        return denormalize(x, self.lr_max, self.mode)

    def denormalize_hr(self, x: Tensor) -> Tensor:
        return denormalize(x, self.hr_max, self.mode)

    # bare stretch/destretch (no clamping or scaling): the metric
    # collections' per-stretch re-scaling (metrics/collection.py)
    def stretch_only(self, x: Tensor) -> Tensor:
        return stretch(x, self.mode)

    def destretch_only(self, x: Tensor) -> Tensor:
        return destretch(x, self.mode)
