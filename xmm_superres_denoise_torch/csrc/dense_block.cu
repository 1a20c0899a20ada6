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
// 5 reading x again), 1,472 B in bf16 at C = 32, 0.51 GB at
// (2, 416, 416, 32): about 190 FLOP per byte, under the bf16 tensor-core
// ridge (~295) but far above the f32 CUDA-core ridge (~20). It is bound by
// operations: 0.097 ms at 989 TFLOP/s in bf16 (the five-launch traffic
// alone takes 0.152 ms at 3.35 TB/s), 1.43 ms at 67 TFLOP/s in f32.
//
// What the design does about it. Two level kernels, chosen by dtype:
// * bf16 runs on the tensor cores through the level entry and epilogue of
//   dense_level_bf16.cuh, which K1 shares. At C % 128 == 0 (the fast
//   forward's C = 128) that is K1's level, wgmma fed by TMA on 16 x 16
//   pixels x 128 channels (conv3x3_wgmma.cuh); at any other C % 32 == 0
//   (the model's C = 32) the implicit GEMM of conv3x3_igemm.cuh (mma.sync
//   m16n8k16 bf16 -> f32) on 16 x 16 pixels x 32 channels, 8 warps of
//   32 x 32, 48,960 B of shared memory (ptxas, nvcc 12.9: 122 registers,
//   no spills). Weights come packed once as (9, C, k*C) bf16
//   (ops/dense_block.py: pack_weights).
// * f32 stays on the CUDA cores (the parity class forbids TF32): a direct
//   convolution with every multiply-add fed from shared memory. Each block
//   computes a 16x16 pixel tile for 32 output channels; each of its 128
//   threads holds 2 pixels x 32 channels of accumulators in registers, so
//   one staged input value feeds 32 FMAs and one broadcast weight row feeds
//   64. The input channels are walked in chunks of 16 (one input halo tile
//   and one HWIO weight slice per chunk). Shared memory per block (static):
//     input tile  (16+2) * (16+2) pixels * (16+1) channels * 4 B = 22,032 B
//                  (+1 channel of padding keeps neighbouring pixels on
//                   different banks)
//     weights     9 taps * 16 in * 32 out * 4 B                   = 18,432 B
//     total                                                        40,464 B
//   which lets five blocks share an SM's 228 KB.
// Neither form fuses the five levels into one launch: at C = 32 a 16x16
// output tile with the 5-deep halo of the fused form needs 26*26*160 f32 =
// 432 KB of concat, above the 227 KB a block may use.

#include <cuda_runtime.h>

#include "dense_level_bf16.cuh"

namespace {

constexpr int TILE = 16;               // output tile edge, pixels
constexpr int HALO_T = TILE + 2;       // staged input tile edge (3x3 halo)
constexpr int CK = 16;                 // input channels staged per step
constexpr int PIX = CK + 1;            // smem floats per staged pixel
constexpr int CO = 32;                 // output channels per block
constexpr int THREADS = 128;
constexpr int ROWS = TILE * TILE / THREADS;  // pixels per thread (2)
constexpr int ROW_STEP = THREADS / TILE;     // row distance between them (8)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }

// src: (B, H, W, src_stride) NHWC; reads channels [0, cin).
// w: (3, 3, cin, C) HWIO; bias: (C,).
// dst: pixel stride dst_stride, already offset to its first channel.
// residual != 0: dst = 0.2 * conv + src[..., co] (the level-5 epilogue).
// src and dst may be the same buffer: reads and writes touch disjoint
// channels, so neither pointer is declared __restrict__.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_level_kernel(const T* src, int H, int W, int src_stride, int cin,
                   const T* __restrict__ w, const T* __restrict__ bias, int C,
                   T* dst, int dst_stride, int residual) {
  __shared__ float s_in[HALO_T * HALO_T * PIX];
  __shared__ __align__(16) float s_w[9 * CK * CO];

  const int groups = C / CO;
  const int b = blockIdx.z / groups;
  const int g = blockIdx.z % groups;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % TILE;
  const int ty = tid / TILE;
  const size_t img = (size_t)b * H * W;

  float acc[ROWS][CO];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[r][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    // stage the (18, 18, 16) input halo tile; zeros outside the image
    for (int i = tid; i < HALO_T * HALO_T * CK; i += THREADS) {
      const int c = i % CK;
      const int p = i / CK;
      const int y = y0 + p / HALO_T - 1;
      const int x = x0 + p % HALO_T - 1;
      float v = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = load_f32(src + (img + (size_t)y * W + x) * src_stride + c0 + c);
      s_in[p * PIX + c] = v;
    }
    // stage the (9, 16, 32) weight slice
    for (int i = tid; i < 9 * CK * CO; i += THREADS) {
      const int co = i % CO;
      const int ci = (i / CO) % CK;
      const int tap = i / (CO * CK);
      s_w[i] = load_f32(w + ((size_t)tap * cin + c0 + ci) * C + g * CO + co);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll 4
      for (int ci = 0; ci < CK; ++ci) {
        float a[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          a[r] = s_in[((ty + r * ROW_STEP + dy) * HALO_T + tx + dx) * PIX + ci];
        const float4* wrow =
            reinterpret_cast<const float4*>(s_w + (tap * CK + ci) * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 wv = wrow[q];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][4 * q + 0] += a[r] * wv.x;
            acc[r][4 * q + 1] += a[r] * wv.y;
            acc[r][4 * q + 2] += a[r] * wv.z;
            acc[r][4 * q + 3] += a[r] * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int y = y0 + ty + r * ROW_STEP;
    const int x = x0 + tx;
    if (y >= H || x >= W) continue;
    const size_t pix = img + (size_t)y * W + x;
    T* out = dst + pix * dst_stride + g * CO;
    const T* res = src + pix * src_stride + g * CO;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      float v = acc[r][c] + load_f32(bias + g * CO + c);
      if (residual)
        v = v * 0.2f + load_f32(res + c);
      else
        v = v >= 0.f ? v : 0.2f * v;
      store_f32(out + c, v);
    }
  }
}

template <typename T>
int launch(const void* src, int B, int H, int W, int src_stride, int cin,
           const void* w, const void* bias, int C, void* dst, int dst_stride,
           int residual, cudaStream_t stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE,
                  B * (C / CO));
  dense_level_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(src), H, W, src_stride, cin,
      static_cast<const T*>(w), static_cast<const T*>(bias), C,
      static_cast<T*>(dst), dst_stride, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32 on the CUDA cores, w HWIO (3, 3, cin, C);
// 1 = bfloat16 on the tensor cores, w packed (9, C, cin). Shapes are checked
// by the Python wrapper: C % 32 == 0, cin % 32 == 0, B * C / 32 < 65536.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int dense_block_level(int device, int dtype, const void* src, int B, int H,
                      int W, int src_stride, int cin, const void* w,
                      const void* bias, int C, void* dst, int dst_stride,
                      int residual, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, B, H, W, src_stride, cin, w, bias, C, dst,
                         dst_stride, residual, s);
  if (dtype == 1)
    return dense_level_bf16::launch(src, B, H, W, src_stride, cin, w, bias, C, dst,
                                    dst_stride, residual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaGetErrorString for the wrapper's messages.
const char* dense_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
