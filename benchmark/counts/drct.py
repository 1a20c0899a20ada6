"""Operations and bytes of DRCT SR, from its shapes.

2 operations per multiply-add of every convolution and matrix product
(qkv, q k^T, attention x v, proj, the MLP, the 1x1 adjust convolutions,
conv_first, conv_after_body, conv_before_upsample, the upsampler and
conv_last), at each block's true width; LayerNorm, softmax, GELU,
LeakyReLU, biases, the relative-position bias, the mask and the
concatenations are not counted, as torch's FlopCounterMode does not count
them. At 416^2 -> 832^2, embed 180, 6 groups of 5 blocks (180, 212, 244,
276 and 308 channels), window 16, gc 32, MLP ratio 4 in blocks 1-3 and 1
in 4-5: about 7.20 TFLOP an image.

`attention_ops` and `attention_bytes` are the window attention's least
work in one image: q k^T and attention x v at the true head sizes, and q,
k, v read once and the output written once in bf16 (about 1.30 TFLOP and
10.1 GB). Padding a head to 64 or 128 channels is the kernel's cost, not
work of the model.
"""

from __future__ import annotations

import math


def widths(cfg: dict) -> list:
    """(channels read, MLP hidden, adjust's output channels) of the five
    blocks of a group."""
    ed, gc = cfg["embed_dim"], cfg["gc"]
    out = []
    for j in range(1, 6):
        c = ed + (j - 1) * gc
        out.append((c, int(c * (cfg["mlp_ratio"] if j <= 3 else 1.0)), ed if j == 5 else gc))
    return out


def _keys(cfg: dict) -> int:
    return cfg["window_size"] ** 2  # the window unclamped (reference/drct.py: window)


def attention_ops(cfg: dict) -> int:
    tokens, groups = cfg["lr_res"] ** 2, len(cfg["num_heads"])
    return groups * sum(2 * 2 * tokens * _keys(cfg) * c for c, _, _ in widths(cfg))


def attention_bytes(cfg: dict) -> int:
    tokens, groups = cfg["lr_res"] ** 2, len(cfg["num_heads"])
    return groups * sum(4 * tokens * c * 2 for c, _, _ in widths(cfg))


def forward_ops(cfg: dict) -> int:
    tokens = cfg["lr_res"] ** 2
    ed, cin, nf = cfg["embed_dim"], cfg["in_channels"], cfg["num_feat"]
    per_group = sum(2 * tokens * c * (3 * c + c + 2 * hidden + c_out)
                    for c, hidden, c_out in widths(cfg))  # qkv, proj, MLP, adjust
    ops = len(cfg["num_heads"]) * per_group + attention_ops(cfg)
    ops += 2 * tokens * 9 * (cin * ed + ed * ed + ed * nf)  # conv_first, after_body, before_up
    for _ in range(int(math.log2(cfg["upscale"]))):
        ops += 2 * tokens * 9 * nf * 4 * nf
        tokens *= 4
    return ops + 2 * tokens * 9 * nf * cin
