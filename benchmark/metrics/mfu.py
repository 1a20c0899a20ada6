"""The whole serving step's share of the chip's peak: the benchmark's own
operation count of one forward (`counts/<family>.py`, from the shapes)
times the images completed per second in the window, over the peak of
the configuration's dtype (`counts/peaks.py`)."""

from benchmark.counts.peaks import PEAK_OPS_PER_S

NAME = "mfu"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model forward"
MOVES = "images_per_s"


def read(ctx: dict):
    rate, ops = ctx.get("images_per_s"), ctx.get("ops_per_image")
    if not rate or not ops:
        return None
    return 100.0 * ops * rate / PEAK_OPS_PER_S[ctx["cfg"]["dtype"]]
