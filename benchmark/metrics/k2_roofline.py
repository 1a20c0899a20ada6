"""K2's share of its roofline: the dense blocks' least time at the chip's
peaks (`counts/rrdb.py`: operations of the five convolutions, bytes of the
block's input, output and weights once; `counts/peaks.py`) for the images
of the traced window, over the device time of K2's level kernels in it.
K2's launches are found by name: its bf16 level at C = 32,
`csrc/conv3x3_wgmma32.cuh`."""

from benchmark.counts import rrdb
from benchmark.counts.peaks import bound_s

NAME = "k2_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
KERNEL = "conv3x3_wgmma32"


def read(ctx: dict):
    trace, cfg = ctx.get("trace"), ctx["cfg"]
    if trace is None or cfg["dtype"] != "bfloat16" or "filters" not in cfg:
        return None
    busy = sum(b - a for n, a, b in trace["ops"] if KERNEL in n)
    if busy <= 0:
        return None
    h, nf, blocks = cfg["lr_res"], cfg["filters"], 3 * cfg["residual_blocks"]
    n = ctx["traced_images"] * blocks
    least, _ = bound_s(n * rrdb.dense_block_ops(h, h, nf),
                       n * rrdb.dense_block_bytes(h, h, nf, 2), "bfloat16")
    return 100.0 * least / busy
