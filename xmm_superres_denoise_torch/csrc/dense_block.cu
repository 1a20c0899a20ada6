// One level of the RRDB residual dense block (ResidualDenseBlock5C) for
// Hopper (sm_90a), with a plain C interface for ctypes: K2.
//
// Replaces: ops/pallas_rrdb.py::dense_block_pallas of the JAX package
// (kernel body _make_dense_block_kernel), the Pallas TPU kernel that fuses
// the whole block into one grid cell with a VMEM concat buffer.
//
// What it computes. The wrapper (ops/dense_block.py) allocates one NHWC
// concat buffer (B, H, W, 5C), copies x into channels [0, C) and launches
// this kernel five times, once per level k = 1..5. Level k is a SAME 3x3
// cross-correlation over the channel prefix [0, k*C) of the buffer, plus
// bias, accumulated in f32:
//   k < 5 : LeakyReLU(0.2), written to buffer channels [k*C, (k+1)*C)
//   k = 5 : 0.2 * conv + x, written to the output (B, H, W, C)
// with one rounding to the storage type per level. SAME zero padding comes
// from the zero fill of the staged input halo.
//
// What bounds it on this card. Per 416^2 image at C = 32 the block is
// 9 * 32^2 * (1+2+3+4+5) * 2 = 276,480 FLOP per pixel, 47.8 GFLOP per
// image. Its five launches move 23 * C values per pixel through device
// memory (x copied in, level k reading its k*C prefix and writing C, level
// 5 reading x again), 1,472 B in bf16 at C = 32, 0.509 GB at
// (2, 416, 416, 32): about 190 FLOP per byte. In bf16 that is under the
// tensor cores' ridge (~295 FLOP per byte), so the five launches are bound
// by their bytes: 0.152 ms at 3.35 TB/s, against 0.097 ms of operations
// at 989 TFLOP/s. In f32 it is far above the CUDA cores' ridge (~20) and
// bound by operations: 1.43 ms at 67 TFLOP/s.
//
// What the design does about it. Two level kernels, chosen by dtype:
// * bf16 runs on the tensor cores through the level entry and epilogue of
//   dense_level_bf16.cuh, which K1 shares. At C % 128 == 0 (the fast
//   forward's C = 128) that is K1's level, wgmma fed by TMA on 16 x 16
//   pixels x 128 channels (conv3x3_wgmma.cuh); at any other C % 32 == 0
//   (the model's C = 32) conv3x3_wgmma32.cuh: a persistent wgmma m64n32k16
//   kernel fed by TMA, two consumer warpgroups taking 16 x 16 pixel tiles
//   in turn from rings of halo boxes while the level's weights stay
//   resident in shared memory, so the level streams the concat buffer
//   instead of waiting on each chunk. Weights come packed once as
//   (9, C, k*C) bf16 (ops/dense_block.py: pack_weights).
// * f32 stays on the CUDA cores (the parity class forbids TF32), in
//   conv3x3_f32.cuh, which K1's f32 levels run too: FFMA only, a
//   persistent grid over 16 x 16 pixel tiles with all 128 output channels
//   of a tile in one block at C % 128 == 0 (32 otherwise), a two-stage
//   cp.async ring of halo and weight chunks, and 8 pixels x 8 channels of
//   accumulators per thread; its note says what bounds it. Weights are
//   read as HWIO, as the caller gives them.
// Neither form fuses the five levels into one launch, which would cut the
// bytes: at C = 32 a 16 x 16 output tile with the 5-deep halo of the fused
// form needs 26*26*160 values of concat, 216 KB in bf16 (432 KB in f32),
// and the block's 276 KB of bf16 weights come on top of the 227 KB a block
// may use.

#include <cuda_runtime.h>

#include "conv3x3_f32.cuh"
#include "device_guard.cuh"
#include "dense_level_bf16.cuh"

extern "C" {

// dtype: 0 = float32 on the CUDA cores, w HWIO (3, 3, cin, C); 1 =
// bfloat16 on the tensor cores, w packed (9, C, cin); buffer and weights
// 16-byte aligned. Shapes are checked by the Python wrapper: C % 32 == 0,
// cin % 32 == 0 (both dtypes launch a one-dimensional persistent grid).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int dense_block_level(int device, int dtype, const void* src, int B, int H,
                      int W, int src_stride, int cin, const void* w,
                      const void* bias, int C, void* dst, int dst_stride,
                      int residual, void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv3x3_f32::launch(src, B, H, W, src_stride, cin, w, bias, C, dst,
                               dst_stride, residual, s);
  if (dtype == 1)
    return dense_level_bf16::launch(src, B, H, W, src_stride, cin, w, bias, C, dst,
                                    dst_stride, residual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory that one f32 level block asks for at channel count C.
int dense_block_f32_smem_bytes(int C) {
  return C % 128 == 0 ? conv3x3_f32::Cfg<128>::SMEM : conv3x3_f32::Cfg<32>::SMEM;
}

// Dynamic shared memory that one bf16 level block asks for at C % 128 != 0,
// reading cin channels (conv3x3_wgmma32.cuh: resident weights at C = 32).
int dense_block_bf16_smem_bytes(int cin, int C) { return conv3x3_wgmma32::smem_bytes(cin, C); }

// cudaGetErrorString for the wrapper's messages.
const char* dense_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
