"""The model forward's share of the engine's wall time per image: the
forward alone (CUDA events around `InferenceEngine.predict` on a prepared
batch of the serving batch size) over `run_tiles`' wall time per image in
the untimed-by-trace window. What is left is the engine's own work:
upload, prepare, clip, denormalize, readback and the host's concatenate."""

NAME = "engine.forward_share"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "engine"
MOVES = "images_per_s"


def read(ctx: dict):
    fwd, call = ctx.get("forward_ms_per_image"), ctx.get("run_tiles_ms_per_image")
    if not fwd or not call:
        return None
    return 100.0 * fwd / call
