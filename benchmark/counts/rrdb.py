"""Operations and bytes of the esr_gen SR generator, from its shapes.

2 operations per multiply-add of every 3x3 convolution; activations,
biases, pixel shuffles and clamps are not counted. At 416^2 -> 832^2 with
32 filters and 4 RRDB: about 603 GFLOP an image, about 574 of them in the
12 dense blocks.
"""

from __future__ import annotations


def _conv3x3(h: int, w: int, cin: int, cout: int) -> int:
    return 2 * h * w * 9 * cin * cout


def dense_block_ops(h: int, w: int, nf: int) -> int:
    """One dense block on one (h, w, nf) image: five convs reading nf,
    2nf, ..., 5nf channels (growth nf), the first four writing nf, the
    fifth nf."""
    return sum(_conv3x3(h, w, k * nf, nf) for k in range(1, 6))


def dense_block_bytes(h: int, w: int, nf: int, esize: int) -> int:
    """The block's least traffic on one image: its input and output once,
    its weights and biases once."""
    weights = sum(9 * k * nf * nf + nf for k in range(1, 6))
    return (2 * h * w * nf + weights) * esize


def forward_ops(cfg: dict) -> int:
    """One image through the generator at the configuration's sizes."""
    h = w = cfg["lr_res"]
    nf, cin = cfg["filters"], cfg["in_channels"]
    ops = _conv3x3(h, w, cin, nf)
    ops += 3 * cfg["residual_blocks"] * dense_block_ops(h, w, nf)
    ops += _conv3x3(h, w, nf, nf)  # trunk_conv
    for _ in range(cfg["upsample"]):
        ops += _conv3x3(h, w, nf, 4 * nf)
        h, w = 2 * h, 2 * w
    ops += _conv3x3(h, w, nf, nf) + _conv3x3(h, w, nf, cfg["out_channels"])
    return ops
