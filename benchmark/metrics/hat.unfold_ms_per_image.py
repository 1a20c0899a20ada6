"""Device time per image of OCAB's `F.unfold`, which cuts the keys' and
values' overlapping windows: the `im2col` kernels in the traced window.
Nothing else on HAT's path launches them."""

NAME = "hat.unfold_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
KERNEL = "im2col"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    s = sum(b - a for n, a, b in trace["ops"] if KERNEL in n)
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
