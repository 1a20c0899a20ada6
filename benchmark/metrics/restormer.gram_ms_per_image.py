"""Device time per image of the GEMMs with float32 operands in the traced
window. On Restormer's bfloat16 path these are only MDTA's Grams q k^T,
from q and k upcast, a (d x d) product per head contracted over every
pixel (173,056 at level 1), with TF32 off. A GEMM kernel is one of the
zoo's GEMM group (`zoo.elementwise_ms_per_image`'s `group`); its operands
are float32 where its name says so as cuBLAS names them on an H100
(`sm80_xmma_gemm_f32f32_f32f32_f32_{nt,nn}_n_tilesize32x32x8_..._ffma_...`:
A, B, C and D float32, on the CUDA cores), 44 a forward."""

from benchmark.harness import module

NAME = "restormer.gram_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "images_per_s"
GROUP = "GEMM (cuBLAS)"
F32 = "f32f32_f32f32"


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("traced_images"):
        return None
    group = module("metrics", "zoo.elementwise_ms_per_image").group
    s = sum(b - a for n, a, b in trace["ops"] if group(n) == GROUP and F32 in n)
    return 1e3 * s / ctx["traced_images"] if s > 0 else None
