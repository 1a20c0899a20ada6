"""Device time per image of the depthwise 3x3 convolutions in the traced
window: MDTA's `qkv_dwconv` and GDFN's `dwconv`, 88 a forward, each one
launch of `conv2d_c1_k1_nhwc` on an H100 (channel multiplier 1, kernel 1,
channels-last). Nothing else on Restormer's path launches it."""

NAME = "restormer.dwconv_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
KERNEL = "conv2d_c1_k1_nhwc"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    s = sum(b - a for n, a, b in trace["ops"] if KERNEL in n)
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
