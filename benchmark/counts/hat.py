"""Operations of HAT SR, from its shapes.

2 operations per multiply-add of every convolution and matrix product
(qkv, q k^T, attention x v, proj, MLP; the CAB's 3x3 convolutions and its
channel attention's 1x1 convolutions on the pooled features; OCAB's
256 x 576 attention); LayerNorm, softmax, GELU, sigmoid, biases, the
relative-position bias and the mask are not counted, as torch's
FlopCounterMode does not count them. At 416^2 -> 832^2, embed 180, 6 x 6
HABs, window 16, overlap 0.5, MLP ratio 4: about 10.45 TFLOP an image, 2.42
of them in the CAB convolutions.
"""

from __future__ import annotations

import math


def forward_ops(cfg: dict) -> int:
    tokens = cfg["lr_res"] ** 2
    c, cin, nf = cfg["embed_dim"], cfg["in_channels"], cfg["num_feat"]
    ws = cfg["window_size"]
    wse = ws + int(cfg["overlap_ratio"] * ws)
    hidden = int(c * cfg["mlp_ratio"])
    mid, sq = c // cfg["compress_ratio"], c // cfg["squeeze_factor"]

    def attention(keys: int) -> int:  # qkv, logits, attention x v, proj, MLP
        return 2 * tokens * c * (3 * c + 2 * keys + c + 2 * hidden)

    cab = 2 * tokens * 9 * 2 * c * mid + 2 * 2 * c * sq
    ops = sum(cfg["depths"]) * (attention(ws * ws) + cab)
    ops += len(cfg["depths"]) * (attention(wse * wse) + 2 * tokens * 9 * c * c)
    ops += 2 * tokens * 9 * (cin * c + c * c + c * nf)  # conv_first, after_body, before_up
    for _ in range(int(math.log2(cfg["upscale"]))):
        ops += 2 * tokens * 9 * nf * 4 * nf
        tokens *= 4
    return ops + 2 * tokens * 9 * nf * cin
