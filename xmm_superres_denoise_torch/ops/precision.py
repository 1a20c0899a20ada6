"""Precision helpers: the true-f32 context and JAX's bf16 scalar rounding.

The port's counterpart of the JAX package's `ops/precision.py`. On
the TPU the default precision multiplies f32 operands in bf16; on Hopper
the analog is TF32, which cuDNN uses for f32 convolutions by default
(`torch.backends.cudnn.allow_tf32` is True) and which keeps about three
decimal digits. The f32 parity configuration therefore runs with TF32 off
for both convolutions and matmuls. On the CPU the flags change nothing.

`scalar_like` and `lrelu` reproduce JAX's rounding of a Python-float
scalar that meets a bf16 tensor (see `scalar_like`).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def true_f32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, and restore
    both flags on exit."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


def scalar_like(x: torch.Tensor, s: float) -> torch.Tensor:
    """`s` as a 0-d tensor of `x.dtype` on `x.device`.

    JAX multiplies a bf16 array by a Python float in bf16: the weak-typed
    scalar is rounded to bf16 first. PyTorch multiplies in f32 with the
    scalar unrounded, which moves about a fifth of bf16 products by one ulp.
    A scalar of the tensor's own dtype reproduces JAX's rounding; in f32 the
    scalar rounds to itself, so f32 results do not change.

    The scalar is filled on `x.device`, rounded on the host as
    `torch.tensor` rounds it. A tensor made on the host and copied to a card
    is a pageable copy, which synchronises the stream: the host would wait
    at every use for the card's queue to drain."""
    return torch.full((), s, dtype=x.dtype, device=x.device)


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU in JAX's `where` form, `x >= 0 ? x : x * slope`, with the
    slope rounded to `x.dtype` (`scalar_like`)."""
    return torch.where(x >= 0, x, x * scalar_like(x, slope))
