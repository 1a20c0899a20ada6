"""The device's idle share of the traced window of whole calls: 1 - the
union of its operations' intervals over the window's length."""

NAME = "idle_share"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "images_per_s"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
