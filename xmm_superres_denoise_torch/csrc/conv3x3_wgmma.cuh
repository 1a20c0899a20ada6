// A SAME 3x3 convolution over a channel prefix of an NHWC buffer as an
// implicit GEMM on wgmma, fed by TMA, for Hopper (sm_90a), in two element
// types (the template parameter Op):
// * Bf16: the bf16 dense-block level at C % 128 == 0. K1
//   (dense_block_s2d.cu) and K2 at C % 128 == 0 (dense_block.cu, the fast
//   bf16 forward) reach it through dense_level_bf16.cuh, which owns the
//   epilogue. The notes below are written for this one.
// * S8: K3's s8 x s8 -> s32 level at cin % 128 == 0 (conv_i8.cu, which
//   owns the int8 forward's epilogue), wgmma.mma_async.m64n128k32.s32.s8.s8.
//   In bytes the two are the same kernel: a chunk is 128 bytes of input
//   channels (64 bf16 or 128 s8, one swizzle row), a k-step 32 bytes (k16
//   bf16, k32 s8), and the A fragments that ldmatrix loads hold the same
//   bytes per register in both; only the instruction, the accumulator type
//   and the TMA element type differ.
//
// Replaces: ops/pallas_dense_block.py::dense_block_s2d_pallas of the JAX
// package (body _make_kernel), per level: the (M, k*128) x (k*128, 128)
// products the TPU body issues per tap. The fused 5-level VMEM concat of
// the TPU kernel does not fit a block's 227 KB (dense_block_s2d.cu), so the
// level stays one launch over the NHWC concat buffer.
//
// What bounds it. At the serving shape (2, 208, 208, 128) the five levels
// are 383 GFLOP as computed against ~0.4 GB of device-memory traffic: bound
// by operations, 0.387 ms at 989 TFLOP/s.
//
// GEMM view and design. M = output pixels, N = 128 output channels per
// block, K = 9 taps x cin. A block (3 warpgroups, 384 threads, one block per
// SM) computes a 16 x 16 pixel tile (M = 256) for 128 channels:
// * Consumers: warpgroups 0 and 1 each own 8 tile rows, as two m64 blocks
//   of 4 rows (one row of 16 px per warp), and issue
//   wgmma.mma_async.m64n128k16 bf16 -> f32 with A from registers (RS) and B
//   from shared memory; 2 x 64 f32 accumulators per thread
//   (setmaxnreg 232).
// * Producer: one thread of warpgroup 2 (setmaxnreg 40) issues every TMA
//   load and waits on mbarriers; the consumers never stage anything.
// * B (weights, packed (9, C, cin), input channels contiguous: K-major per
//   output channel, as wgmma's B wants) comes through a ring of STAGES
//   slices of one (tap, 64-channel chunk) each, 128 x 64 bf16 = 16 KB with
//   the 128-byte swizzle, read by wgmma through a shared-memory descriptor.
// * A (activations) comes from one (16+2) x (16+2) x 64-channel halo box per
//   chunk, loaded by one 4-D TMA box at (c0, x0-1, y0-1, b) and double
//   buffered. TMA fills the box's out-of-image elements with zeros, negative
//   coordinates included: that is SAME padding. A tap (dy, dx) is the halo
//   window shifted by whole pixels, which does not line up with the 8-row
//   core matrices of a wgmma descriptor, so A goes through registers: each
//   lane's ldmatrix row address XORs the 16-byte chunk index with the pixel
//   index mod 8 (the TMA's 128-byte swizzle), which also keeps the eight
//   rows of each 8 x 8 matrix on distinct banks.
// What it does about the mma.sync tile it replaces (an implicit GEMM on
// 8 x 16 px x 128 channels, 2 blocks per SM):
// 1. wgmma reads B once per warpgroup instead of each warp loading its own
//    fragments with 32-bit shared loads;
// 2. loads overlap the math: STAGES weight slices and two halo boxes are in
//    flight while the consumers multiply, and each step keeps one wgmma
//    group in flight while the next A fragments load;
// 3. 256 pixels per block instead of 128 halves the weight bytes per pixel
//    that the blocks read from L2 (about 1.5 GB per block call at the
//    serving shape instead of 3.0) and the halo overhead (324 staged pixels
//    per 256 instead of 180 per 128);
// 4. waves: 338 tiles at the serving shape on 132 SMs, 2.56 waves, the same
//    fraction as before (676 on 264 slots). A persistent loop over tiles
//    would not change that fraction; only a tile count matched to the SMs,
//    or splitting tiles along K, would.
//
// Shared memory (dynamic): STAGES * 16,384 B of weights, 2 * 41,984 B of
// halo (41,472 B rounded up to the 1024-byte swizzle atom), the mbarriers
// and 1 KB to align the base to 1024 bytes.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace conv3x3_wgmma {

using namespace tma;
using namespace wgmma;

constexpr int TH = 16, TW = 16;  // output tile rows x columns (M = 256)
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int BN = 128;          // output channels per block (N)
constexpr int CHUNK = 128;       // bytes of input channels per chunk: one swizzle row
constexpr int STAGES = 6;        // depth of the weight ring
constexpr int W_STAGE = BN * CHUNK;                             // 16,384 B
constexpr int HALO_BYTES = HALO_H * HALO_W * CHUNK;             // 41,472 B
constexpr int HALO_SLOT = (HALO_BYTES + 1023) / 1024 * 1024;    // 41,984 B
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BARS = 2 * STAGES + 4;  // w_full, w_empty, h_full, h_empty
constexpr int BAR_OFF = STAGES * W_STAGE + 2 * HALO_SLOT;
constexpr int SMEM = 1024 + BAR_OFF + 8 * BARS;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// The element types of the level: the accumulator, the TMA element type
// and its size, the input channels of one 128-byte chunk, and one k-step
// (32 bytes of K) of wgmma.
struct Bf16 {
  using Acc = float;
  static constexpr int ELEM = 2;
  static constexpr int KC = CHUNK / ELEM;  // 64 channels per chunk
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(Acc (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    wgmma_m64n128k16(d, a, desc);
  }
};

struct S8 {
  using Acc = int;
  static constexpr int ELEM = 1;
  static constexpr int KC = CHUNK / ELEM;  // 128 channels per chunk
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(Acc (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    wgmma_m64n128k32_s8(d, a, desc);
  }
};

// An epilogue that sets `kFragment` takes the thread's whole accumulator at
// once, epi.fragment(acc, b * H, H, W, y, x, n): acc[mb][4j + 2*half + e] is
// output pixel (y + 4*mb, x + 8*half), channel n + 8j + e. Any other
// epilogue is called once per pair (the kernel note below).
template <class E, class = void>
struct TakesFragment : std::false_type {};
template <class E>
struct TakesFragment<E, std::void_t<decltype(E::kFragment)>> : std::bool_constant<E::kFragment> {};

// The A fragments of one k-step for the thread's two m64 blocks: tap `tap`
// of the halo at `halo`, 32-byte step `kk` of the chunk. prow[mb] is the
// halo pixel of this lane's ldmatrix row at tap (0, 0), khalf which 16-byte
// half of the step it addresses.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], uint32_t halo, const int (&prow)[2],
                                       int khalf, int tap, int kk) {
  const int shift = (tap / 3) * HALO_W + tap % 3;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int p = prow[mb] + shift;
    ldmatrix_x4(a[mb], halo + p * 128 + (((2 * kk + khalf) ^ (p & 7)) << 4));
  }
}

// in_map: the (B, H, W, cin) prefix of the concat buffer, box
// (Op::KC, 18, 18, 1); w_map: the packed (9, cout, cin) weights, box
// (Op::KC, 128, 1); both with the 128-byte swizzle. For every output pixel
// `pix` (flat index b*H*W + y*W + x) and even output channel n, the
// epilogue gets epi(pix, n, acc[n], acc[n + 1]).
template <class Op, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap in_map,
                     const __grid_constant__ CUtensorMap w_map, int H, int W, int chunks,
                     int groups, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t w_ring = base;
  const uint32_t halo0 = base + STAGES * W_STAGE;
  const uint32_t bars = base + BAR_OFF;
  const auto w_full = [&](int s) { return bars + 8 * s; };
  const auto w_empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const auto h_full = [&](int h) { return bars + 8 * (2 * STAGES + h); };
  const auto h_empty = [&](int h) { return bars + 8 * (2 * STAGES + 2 + h); };

  const int b = blockIdx.z / groups;
  const int n0 = (blockIdx.z % groups) * BN;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), CONSUMERS);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(h_full(h), 1);
      mbar_init(h_empty(h), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: chunk c's halo box, then its 9 weight slices through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int c = 0; c < chunks; ++c) {
        const int h = c & 1;
        if (c >= 2) mbar_wait(h_empty(h), ((c >> 1) - 1) & 1);
        mbar_expect_tx(h_full(h), HALO_BYTES);
        tma_load_4d(halo0 + h * HALO_SLOT, &in_map, h_full(h), c * Op::KC, x0 - 1, y0 - 1, b);
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(w_empty(s), ph ^ 1);
          mbar_expect_tx(w_full(s), W_STAGE);
          tma_load_3d(w_ring + s * W_STAGE, &w_map, w_full(s), c * Op::KC, n0, tap);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    // ldmatrix x4: lanes 8i..8i+7 address the rows of matrix i: pixels 0-7
    // (i even) or 8-15 (i odd) of the warp's tile row, 16-byte half i / 2
    const int khalf = lane >> 4;
    int prow[2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
      prow[mb] = (wg * 8 + mb * 4 + warp) * HALO_W + (lane & 7) + (lane & 8);

    typename Op::Acc acc[2][64];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mb][i] = 0;
    uint32_t a[2][2][4] = {};  // [k-step parity][m block][register]

    int s = 0, prev = 0;
    uint32_t ph = 0;
    mbar_wait(h_full(0), 0);
    load_a(a[0], halo0, prow, khalf, 0, 0);
    for (int c = 0; c < chunks; ++c) {
      const uint32_t halo = halo0 + (c & 1) * HALO_SLOT;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait(w_full(s), ph);
        const uint64_t desc = desc_sw128(w_ring + s * W_STAGE);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int i = 0; i < 64; ++i) keep(acc[mb][i]);
          wgmma_fence();
          Op::mma(acc[0], a[kk & 1][0], desc + 2 * kk);
          Op::mma(acc[1], a[kk & 1][1], desc + 2 * kk);
          wgmma_commit();
          // the previous step's group is done: its A registers are free, and
          // at a slice's first step the previous slice (and, at tap 0, the
          // previous chunk's halo) goes back to the producer
          wgmma_wait<1>();
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int r = 0; r < 4; ++r) keep(a[(kk + 1) & 1][mb][r]);
          if (kk == 0 && (c | tap) != 0 && (threadIdx.x & 127) == 0) {
            mbar_arrive(w_empty(prev));
            if (tap == 0) mbar_arrive(h_empty((c - 1) & 1));
          }
          if (kk < 3) {
            load_a(a[(kk + 1) & 1], halo, prow, khalf, tap, kk + 1);
          } else if (tap < 8) {
            load_a(a[0], halo, prow, khalf, tap + 1, 0);
          } else if (c + 1 < chunks) {
            const int h = (c + 1) & 1;
            mbar_wait(h_full(h), ((c + 1) >> 1) & 1);
            load_a(a[0], halo0 + h * HALO_SLOT, prow, khalf, 0, 0);
          }
        }
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(acc[mb][i]);

    // d[4j + 2*half + e]: row lane/4 + 8*half of the warp's 16, column
    // 8j + 2*(lane%4) + e
    const int g = lane >> 2, t = lane & 3;
    if constexpr (TakesFragment<Epi>::value) {
      epi.fragment(acc, (size_t)b * H, H, W, y0 + wg * 8 + warp, x0 + g, n0 + 2 * t);
    } else {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int y = y0 + wg * 8 + mb * 4 + warp;
        if (y >= H) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = x0 + g + 8 * half;
          if (x >= W) continue;
          const size_t pix = ((size_t)b * H + y) * W + x;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            epi(pix, n0 + 8 * j + 2 * t, acc[mb][4 * j + 2 * half], acc[mb][4 * j + 2 * half + 1]);
        }
      }
    }
  }
}

// buf: NHWC of Op's element type, buf_stride elements between pixels, read
// over channels [0, cin); w: packed (9, cout, cin) of the same type. Needs
// cin % Op::KC == 0, cout % 128 == 0, and what TMA needs: 16-byte-aligned
// base addresses and strides (the Python wrappers check these and raise;
// here they return cudaErrorInvalidValue / cudaErrorMisalignedAddress).
// Launches on `stream` and returns the cudaError_t of the launch.
template <class Op, class Epi>
int launch(const void* buf, int B, int H, int W, int buf_stride, int cin, const void* w,
           int cout, Epi epi, cudaStream_t stream) {
  if (cin % Op::KC || cout % BN || cin > buf_stride) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(buf) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      (buf_stride * Op::ELEM) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t px = static_cast<cuuint64_t>(buf_stride) * Op::ELEM;  // bytes per pixel
  const cuuint64_t in_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                                 static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t in_strides[3] = {px, px * W, px * W * H};
  const cuuint32_t in_box[4] = {Op::KC, HALO_W, HALO_H, 1};
  CUtensorMap in_map, w_map;
  if (encode(&in_map, Op::TMA_TYPE, 4, const_cast<void*>(buf), in_dims,
             in_strides, in_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout), 9};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cin) * Op::ELEM,
                                   static_cast<cuuint64_t>(cin) * Op::ELEM * cout};
  const cuuint32_t w_box[3] = {Op::KC, BN, 1};
  if (encode(&w_map, Op::TMA_TYPE, 3, const_cast<void*>(w), w_dims, w_strides,
             w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = conv3x3_wgmma_kernel<Op, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (cout / BN));
  kernel<<<grid, THREADS, SMEM, stream>>>(in_map, w_map, H, W, cin / Op::KC, cout / BN, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv3x3_wgmma
