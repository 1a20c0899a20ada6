"""Operations of Restormer de-noising, from its shapes.

2 operations per multiply-add of every convolution, the depthwise 3x3
ones included, and of both of MDTA's products over the pixels (the
(d x d) Gram q k^T and attention x v, per head); LayerNorm, the L2
normalisation, the temperature, softmax, GELU, the gate and the residual
adds are not counted, as torch's FlopCounterMode does not count them. At
416^2, dim 48, blocks [4, 6, 6, 8] and 4 refinement blocks, heads [1, 2,
4, 8], expansion 2.66: about 817.1 GFLOP an image.
"""

from __future__ import annotations


def forward_ops(cfg: dict) -> int:
    px = cfg["lr_res"] ** 2
    d, cin, cout = cfg["dim"], cfg["in_channels"], cfg["out_channels"]
    nb, heads = cfg["num_blocks"], cfg["heads"]

    def block(c: int, nh: int) -> int:  # MDTA then GDFN, per pixel
        hidden = int(c * cfg["ffn_expansion_factor"])
        mdta = c * 3 * c + 3 * c * 9 + 2 * c * (c // nh) + c * c
        gdfn = c * 2 * hidden + 2 * hidden * 9 + hidden * c
        return mdta + gdfn

    def stage(level: int, n: int, c: int) -> int:  # n blocks at a level's resolution
        return n * (px >> (2 * level)) * block(c, heads[level])

    macs = px * 9 * cin * d  # patch_embed
    for lvl in range(3):  # encoder levels 1-3, each then halved by a Downsample
        c = d << lvl
        macs += stage(lvl, nb[lvl], c) + (px >> (2 * lvl)) * 9 * c * (c // 2)
    macs += stage(3, nb[3], d * 8)  # latent
    for lvl in (2, 1, 0):  # decoder: Upsample from the level below, then its blocks
        below = d << (lvl + 1)
        macs += (px >> (2 * (lvl + 1))) * 9 * below * 2 * below
        if lvl:
            macs += (px >> (2 * lvl)) * 2 * (d << lvl) * (d << lvl)  # reduce_chan 1x1
            macs += stage(lvl, nb[lvl], d << lvl)
        else:
            macs += stage(0, nb[0], 2 * d)  # decoder level 1 runs at 2 * dim
    macs += stage(0, cfg["num_refinement_blocks"], 2 * d)
    macs += px * 9 * 2 * d * cout  # output
    return 2 * macs
