"""Device time per image of the cuDNN convolutions in the traced window:
the kernels of the zoo's convolution group (`zoo.elementwise_ms_per_image`'s
`group`), `im2col` excluded, cuDNN's own layout kernels included (on an
H100 its `nhwcAddPaddingKernel`, which pads HAT's 180 and 60 channels). On
HAT's path 2.42 of the model's 3.2 TFLOP of convolution are the CABs' 3x3
convolutions (`counts/hat.py`)."""

from benchmark.harness import module

NAME = "hat.conv_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
GROUP = "convolution (cuDNN)"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    group = module("metrics", "zoo.elementwise_ms_per_image").group
    s = sum(b - a for n, a, b in trace["ops"] if group(n) == GROUP and "im2col" not in n)
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
