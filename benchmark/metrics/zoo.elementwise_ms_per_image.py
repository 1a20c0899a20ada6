"""Device time per image of the kernels that the zoo's profile puts in its
elementwise group (copies, casts, adds, GELU, permutes and the rest that is
not a GEMM, convolution, softmax, LayerNorm or FFT), in the traced window.
Device copies and sets are not kernels and are left out.
`group` is frozen from `chip_smoke.py: _zoo_group`."""

NAME = "zoo.elementwise_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"


def group(name: str) -> str:
    low = name.lower()
    if "fft" in low:
        return "FFT"
    if any(k in low for k in ("conv", "cudnn", "fprop", "implicit", "im2col", "depthwise")):
        return "convolution (cuDNN)"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90", "cublas", "gemv")):
        return "GEMM (cuBLAS)"
    if "softmax" in low:
        return "softmax"
    if "layer_norm" in low or "layernorm" in low:
        return "LayerNorm"
    return "elementwise, copies and the rest"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    kernels = [(n, a, b) for n, a, b in trace["ops"] if not n.startswith(("Memcpy", "Memset"))]
    s = sum(b - a for n, a, b in kernels if group(n) == "elementwise, copies and the rest")
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
