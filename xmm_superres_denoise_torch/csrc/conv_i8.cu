// K3: a SAME 3x3 convolution of int8 activations with int8 weights,
// returning the exact int32 sums, for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces: ops/int8_forward.py::_conv_i8 of the JAX package, the XLA
// s8 x s8 -> s32 convolution (conv_general_dilated with
// preferred_element_type=int32) that carries every convolution of int8
// serving. PyTorch has no CUDA int8 convolution, so this is a hand kernel.
//
// What it computes. x8 (B, H, W, Cin) NHWC int8, with any pixel stride (so
// a channel prefix of a wider buffer can be read in place), weights packed
// by the wrapper once as (9, Cout, Cin) int8; out (B, H, W, Cout) int32:
//   out[b, y, x, o] = sum_{dy, dx, c} x8[b, y+dy-1, x+dx-1, c] * w[dy, dx, c, o]
// with zeros outside the image. Cin is a multiple of 32 (the wrapper pads
// conv_first's 4 channels to 32 with zeros, which adds nothing), Cout a
// multiple of 128. |sum| <= 9 * 640 * 127^2 ~ 9.3e7 fits int32.
//
// Design. The implicit GEMM of conv3x3_igemm.cuh on its Tile128 (8 x 16
// pixels x 128 channels, 8 warps of the 32 x 64 mma_tile warp tile,
// mma.sync m16n8k32 s8 -> s32), one k-step per staged chunk of 32 input
// channels; 63,936 B of dynamic shared memory per block.
// ptxas (nvcc 12.8, sm_90a): 126 registers, no spills.
//
// What bounds it on this card. At the trunk's level-5 shape, (2, 208, 208,
// 640) -> 128, it does 2 * (2*208*208) * 128 * (9*640) = 127.6 G int8 ops
// on 55.4 MB in and 44.3 MB out: ~1,280 ops per byte, above the ~590 int8
// ops per byte ridge of an H100 SXM (1,979 TOPS over 3.35 TB/s), so it is
// bound by operations (0.064 ms at the published peak). conv_first (Cin 4,
// padded to 32, 128 out) is bound by bytes: it writes 44 MB of int32.

#include "conv3x3_igemm.cuh"

namespace {

struct StoreI32 {
  int* out;
  int cout;
  __device__ __forceinline__ void operator()(size_t pix, int n, int v0, int v1) const {
    *reinterpret_cast<int2*>(out + pix * cout + n) = make_int2(v0, v1);
  }
};

}  // namespace

extern "C" {

// x8: int8 with `src_stride` bytes between pixels; w: packed (9, cout, cin)
// int8; out: (B, H, W, cout) int32. Shapes and alignment are checked by the
// Python wrapper: cin % 32 == 0, cout % 128 == 0, src_stride % 16 == 0,
// 16-byte aligned pointers. Returns the cudaError_t of the launch.
int conv_i8(int device, const void* x8, int B, int H, int W, int src_stride,
            int cin, const void* w, int cout, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return igemm::launch<mma_tile::S8, 32, igemm::Tile128>(
      x8, B, H, W, src_stride, cin, w, cout, StoreI32{static_cast<int*>(out), cout},
      static_cast<cudaStream_t>(stream));
}

const char* conv_i8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
