"""The window attention kernel's share of its roofline on DRCT: the least
time at the chip's peaks (`counts/peaks.py: bound_s`) of the 30 attentions
of each image of the traced window, at the true head sizes
(`counts/drct.py`: q k^T and attention x v; q, k, v read once and the
output written once in bf16), over the device time of the kernel's
launches in the window. The kernel is found by name:
`window_attention_sm90_kernel` (`csrc/window_attention.cu`). Padding a
head to 64 or 128 channels counts as the kernel's time, not as work."""

from benchmark.counts import drct
from benchmark.counts.peaks import bound_s

NAME = "drct.attention_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
KERNEL = "window_attention_sm90_kernel"


def read(ctx: dict):
    trace, cfg = ctx.get("trace"), ctx["cfg"]
    if trace is None or cfg.get("family") != "drct" or not ctx.get("traced_images"):
        return None
    busy = sum(b - a for n, a, b in trace["ops"] if KERNEL in n)
    if busy <= 0:
        return None
    n = ctx["traced_images"]
    least, _ = bound_s(n * drct.attention_ops(cfg), n * drct.attention_bytes(cfg), cfg["dtype"])
    return 100.0 * least / busy
