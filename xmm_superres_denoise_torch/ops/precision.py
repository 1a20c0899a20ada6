"""True-f32 context for the parity-class forward on the card.

The port's counterpart of the JAX package's `ops/precision.py`. On
the TPU the default precision multiplies f32 operands in bf16; on Hopper
the analog is TF32, which cuDNN uses for f32 convolutions by default
(`torch.backends.cudnn.allow_tf32` is True) and which keeps about three
decimal digits. The f32 parity configuration therefore runs with TF32 off
for both convolutions and matmuls. On the CPU the flags change nothing.
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
