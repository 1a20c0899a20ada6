"""Device time per image of the kernels that `torch.cat` launches
(`CatArrayBatchedCopy*`) in the traced window. On DRCT's serving path they
are the dense features of each group, 4 concatenations a group of up to
308 channels (`models/drct.py: RDG`); their byte floor is about 4.3 GB an
image, 1.3 ms at 3.35 TB/s."""

NAME = "drct.concat_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
KERNEL = "CatArrayBatchedCopy"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    s = sum(b - a for n, a, b in trace["ops"] if KERNEL in n)
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
