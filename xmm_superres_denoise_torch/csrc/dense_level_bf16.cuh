// One bf16 level of the residual dense block on the tensor cores, shared by
// K2 (dense_block.cu, any C % 32 == 0) and K1 (dense_block_s2d.cu, C = 128):
// the one copy of the level's epilogue and of its choice of kernel.
//
// Level k is a SAME 3x3 convolution over the concat prefix [0, k*C) of the
// (B, H, W, buf_stride) bf16 buffer, with f32 accumulation and an f32 bias.
// The epilogue, in f32 with one rounding to bf16 at the store:
//   k < 5 : LeakyReLU(0.2), stored to channels [k*C, (k+1)*C)
//   k = 5 : 0.2 * v + x, stored to the output (B, H, W, C)
// which is what the TPU kernels compute per level (one rounding per level).
//
// Kernel: C % 128 == 0 takes conv3x3_wgmma.cuh (wgmma fed by TMA, 16 x 16
// pixels x 128 channels per block: K1's level, and K2 at such a width);
// any other C % 32 == 0 takes conv3x3_wgmma32.cuh (a persistent wgmma
// m64n32k16 kernel fed by TMA over 16 x 16 pixel x 32 channel items, the
// level's weights resident in shared memory at the model's C = 32).
#pragma once

#include <cuda_bf16.h>

#include "conv3x3_wgmma.cuh"
#include "conv3x3_wgmma32.cuh"

namespace dense_level_bf16 {

// bias, then LeakyReLU(0.2) into the concat buffer, or 0.2 * v + x into
// the output; f32 arithmetic, one rounding to bf16 at the store. The bias
// and the residual are read through the read-only path (__ldg): the level
// never writes them, and it tells the compiler that the stores of one call
// cannot alias the loads of the next, so an unrolled caller loads them up
// front instead of one store's round trip at a time.
struct Epilogue {
  const __nv_bfloat16* bias;
  const __nv_bfloat16* res;  // the block input x: buffer channels [0, C)
  int res_stride;
  __nv_bfloat16* dst;
  int dst_stride;
  int residual;
  __device__ __forceinline__ void operator()(size_t pix, int n, float v0, float v1) const {
    v0 += __bfloat162float(__ldg(bias + n));
    v1 += __bfloat162float(__ldg(bias + n + 1));
    if (residual) {
      const __nv_bfloat162 r =
          __ldg(reinterpret_cast<const __nv_bfloat162*>(res + pix * res_stride + n));
      v0 = v0 * 0.2f + __low2float(r);
      v1 = v1 * 0.2f + __high2float(r);
    } else {
      v0 = v0 >= 0.f ? v0 : 0.2f * v0;
      v1 = v1 >= 0.f ? v1 : 0.2f * v1;
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + pix * dst_stride + n) =
        __floats2bfloat162_rn(v0, v1);
  }
};

// w is packed (9, C, cin) bf16. buf: the concat buffer, buf_stride elements
// between pixels, read over channels [0, cin); dst: the level's first output
// channel, dst_stride elements between pixels; residual != 0 for level 5.
// C % 32 == 0, cin % 32 == 0 and the 16-byte alignment TMA needs (checked
// by the Python wrappers). Returns the cudaError_t of the launch.
inline int launch(const void* buf, int B, int H, int W, int buf_stride, int cin,
                  const void* w, const void* bias, int C, void* dst, int dst_stride,
                  int residual, cudaStream_t stream) {
  const Epilogue epi{static_cast<const __nv_bfloat16*>(bias),
                     static_cast<const __nv_bfloat16*>(buf), buf_stride,
                     static_cast<__nv_bfloat16*>(dst), dst_stride, residual};
  if (C % 128 == 0)
    return conv3x3_wgmma::launch<conv3x3_wgmma::Bf16>(buf, B, H, W, buf_stride, cin, w, C, epi,
                                                      stream);
  return conv3x3_wgmma32::launch(buf, B, H, W, buf_stride, cin, w, C, epi, stream);
}

}  // namespace dense_level_bf16
