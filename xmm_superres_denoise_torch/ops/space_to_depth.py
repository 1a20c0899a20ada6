"""2x2 space-to-depth transform of 3x3 convolutions.

The port's copy of the JAX package's `ops/space_to_depth.py`. The identity

    conv3x3(x, w)  ==  d2s( conv3x3( s2d(x), T(w) ) )

holds exactly: `s2d` packs each 2x2 pixel block into 4x the channels
(channel order c*4 + ri*2 + rj, the order of `pixel_unshuffle`) and T maps
(3, 3, Cin, Cout) weights onto (3, 3, 4*Cin, 4*Cout) weights with
structural zeros:

    T(w)[bi+1, bj+1, ci*4 + ri*2 + rj, co*4 + di*2 + dj]
        = w[2*bi + ri - di + 1, 2*bj + rj - dj + 1, ci, co]

so the convolution runs at half resolution with 4x the channels (and 4x the
multiply-adds, a quarter of them zeros). Residual adds, LeakyReLU and
channel concats commute with `s2d`, so a whole RRDB trunk runs in the S2D
domain between one `s2d` and one `d2s`.

* `s2d`, `d2s`: NHWC tensors.
* `s2d_conv_weights`: the numpy transform, bitwise equal to the JAX
  package's (it is the same scatter).
* `s2d_conv_weights_torch`: the same transform as an einsum against the
  constant 0/1 tensor `S2D_M`, differentiable, for training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.rrdb import pixel_shuffle, pixel_unshuffle


def s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order c*4 + ri*2 + rj."""
    return pixel_unshuffle(x, 2)


def d2s(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d`."""
    return pixel_shuffle(x, 2)


def _taps():
    """(di, dj, ri, rj, bi, bj, ky, kx) of every nonzero of the transform."""
    for di in range(2):
        for dj in range(2):
            for ri in range(2):
                for rj in range(2):
                    for bi in (-1, 0, 1):
                        ky = 2 * bi + ri - di
                        if not -1 <= ky <= 1:
                            continue
                        for bj in (-1, 0, 1):
                            kx = 2 * bj + rj - dj
                            if -1 <= kx <= 1:
                                yield di, dj, ri, rj, bi, bj, ky, kx


def s2d_conv_weights(
    w: np.ndarray, b: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Transform (3, 3, Cin, Cout) SAME-conv weights to the S2D domain.

    Returns (w2, b2): w2 (3, 3, 4*Cin, 4*Cout) in w's dtype, b2 (4*Cout,)
    with b2[co*4 + p] = b[co], or None."""
    w = np.asarray(w)
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the s2d transform is for 3x3 kernels, got {kh}x{kw}")
    w2 = np.zeros((3, 3, 4 * cin, 4 * cout), w.dtype)
    for di, dj, ri, rj, bi, bj, ky, kx in _taps():
        w2[bi + 1, bj + 1, ri * 2 + rj :: 4, di * 2 + dj :: 4] = w[ky + 1, kx + 1]
    b2 = None if b is None else np.repeat(np.asarray(b), 4)
    return w2, b2


def _s2d_transform_tensor() -> np.ndarray:
    """The constant 0/1 tensor M (3, 3, 4, 4, 3, 3) with
    T(w)[a, b, ci*4 + r, co*4 + d] = sum_{ky,kx} M[a, b, r, d, ky, kx] w[ky, kx, ci, co]."""
    m = np.zeros((3, 3, 4, 4, 3, 3), np.float32)
    for di, dj, ri, rj, bi, bj, ky, kx in _taps():
        m[bi + 1, bj + 1, ri * 2 + rj, di * 2 + dj, ky + 1, kx + 1] = 1.0
    return m


S2D_M = _s2d_transform_tensor()


def s2d_conv_weights_torch(
    w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Differentiable form of :func:`s2d_conv_weights`: an einsum against
    `S2D_M`, so gradients with respect to the (3, 3, Cin, Cout) weights are
    exact."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the s2d transform is for 3x3 kernels, got {kh}x{kw}")
    m = torch.as_tensor(S2D_M, dtype=w.dtype, device=w.device)
    w2 = torch.einsum("abrdyx,yxio->abirod", m, w).reshape(3, 3, 4 * cin, 4 * cout)
    b2 = None if b is None else torch.repeat_interleave(b, 4)
    return w2, b2
