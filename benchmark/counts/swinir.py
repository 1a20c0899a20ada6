"""Operations of SwinIR SR, from its shapes.

2 operations per multiply-add of every convolution and matrix product
(qkv, q k^T, attention x v, proj, MLP); LayerNorm, softmax, GELU, biases
and the relative position bias are not counted, as torch's FlopCounterMode
does not count them. At 416^2 -> 832^2, embed 180, 6 x 6 blocks, window 13:
about 6.40 TFLOP an image.
"""

from __future__ import annotations

import math


def forward_ops(cfg: dict) -> int:
    h = w = cfg["lr_res"]
    res = cfg["img_size"] // cfg["patch_size"]  # the window clamps to it
    ws = min(res, cfg["window_size"])
    h, w = -(-h // ws) * ws, -(-w // ws) * ws  # reflect-padded
    tokens, c, cin, nf = h * w, cfg["embed_dim"], cfg["in_channels"], cfg["num_feat"]
    hidden = int(c * cfg["mlp_ratio"])
    block = 2 * tokens * c * (3 * c + c + 2 * hidden) + 2 * 2 * tokens * ws * ws * c
    ops = sum(cfg["depths"]) * block + len(cfg["depths"]) * 2 * tokens * 9 * c * c
    ops += 2 * tokens * 9 * (cin * c + c * c + c * nf)  # conv_first, after_body, before_up
    for _ in range(int(math.log2(cfg["upscale"]))):
        ops += 2 * tokens * 9 * nf * 4 * nf
        tokens *= 4
    return ops + 2 * tokens * 9 * nf * cin
