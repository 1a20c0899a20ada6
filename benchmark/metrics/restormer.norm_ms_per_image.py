"""Device time per image of the reductions in the traced window:
`ChannelLayerNorm`'s mean and variance over the channels of each pixel
and MDTA's L2 norms of q and k over the pixels: PyTorch's `reduce_kernel`
(`WelfordOps`, `MeanOps` and `sum_functor` in bfloat16 on an H100), 88 of
each a forward. Nothing else on Restormer's path reduces."""

NAME = "restormer.norm_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
KERNEL = "reduce_kernel"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    s = sum(b - a for n, a, b in trace["ops"] if KERNEL in n)
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
