// K1: one level of the ResidualDenseBlock5C in the 2x2 space-to-depth
// domain (C = 128 channels at half resolution), for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Replaces: ops/pallas_dense_block.py::dense_block_s2d_pallas of the JAX
// package (kernel body _make_kernel, column taps _roll_variants). On the TPU
// one grid cell holds the whole 5-level concat of a (16+10) x (104+16) tile
// in VMEM and masks each level to the true image.
//
// Why not that design here. At C = 128 the concat is 640 channels deep;
// even an 8 x 8 output tile with the 5-deep halo needs 18 * 18 * 640 * 2 B
// = 415 KB of bf16 concat, above the 227 KB a block may use. So, as in K2,
// the wrapper (ops/dense_block_s2d.py) keeps one NHWC concat buffer
// (B, H, W, 5C) in device memory, copies x into channels [0, C) and
// launches this kernel once per level k = 1..5. Level k is a SAME 3x3
// convolution over the channel prefix [0, k*C) plus bias, accumulated in
// f32:
//   k < 5 : LeakyReLU(0.2), stored to channels [k*C, (k+1)*C)
//   k = 5 : 0.2 * conv + x, stored to the output (B, H, W, C)
// SAME zero padding is the zero fill of the staged halo, which is what the
// TPU kernel's per-level mask to the image box computes.
//
// bf16: the tensor-core level of dense_level_bf16.cuh, which K2's bf16
// levels share; at C = 128 that is conv3x3_wgmma.cuh: per level M = output
// pixels, N = 128, K = 9 * k * 128, the (M, k*128) x (k*128, 128) products
// that the TPU body issues per tap, as wgmma.mma_async m64n128k16 bf16 ->
// f32 on 16 x 16 pixel tiles, with the weights through a 6-stage TMA ring
// and the activations from a double-buffered TMA halo box (its note says
// what bounds it and what the design does about it). Weights come packed
// once per forward as (9, C, k*C) bf16 (ops/dense_block.py: pack_weights).
// f32 has no entry here: the wrapper launches K2's f32 level on the CUDA
// cores (dense_block.cu -> conv3x3_f32.cuh, FFMA only, HWIO weights),
// because TF32 would leave the f32 parity class.
// ptxas (nvcc 12.9, sm_90a): 168 registers at launch (setmaxnreg gives the
// consumers 232, the producer 40), no spills, 72 HGMMA in the SASS.
//
// What bounds it on this card. At the serving shape (2, 208, 208, 128) one
// block is 383 GFLOP as computed (4x the nominal 95.7 GFLOP of the 416^2 x
// 32 block, from the structural zeros of the S2D weights) against ~0.4 GB
// of bytes: bound by operations, 0.387 ms in bf16 at 989 TFLOP/s and
// 5.7 ms in f32 at 67 TFLOP/s.

#include "dense_level_bf16.cuh"
#include "device_guard.cuh"

extern "C" {

// w is packed (9, C, cin) bf16.
// buf: the (B, H, W, buf_stride) concat buffer, read over channels
// [0, cin); dst: the level's first output channel, dst_stride elements
// between pixels; residual != 0 for level 5. Shapes are checked by the
// Python wrapper: C % 128 == 0, cin % 32 == 0, B * C / 32 < 65536.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int dense_block_s2d_level(int device, const void* buf, int B, int H, int W,
                          int buf_stride, int cin, const void* w, const void* bias,
                          int C, void* dst, int dst_stride, int residual,
                          void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  return dense_level_bf16::launch(buf, B, H, W, buf_stride, cin, w, bias, C, dst, dst_stride,
                                  residual, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory that one bf16 level block asks for at launch.
int dense_block_s2d_smem_bytes() { return conv3x3_wgmma::SMEM; }

const char* dense_block_s2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
