// P: an s8 x s8 -> s32 matrix product on the tensor cores, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces: the probe `kernel` of scripts/device_probe_pallas_int8.py of
// the JAX repository, a Pallas TPU kernel that multiplies (2048, 128) by
// (128, 128) int8 with int32 accumulation and is checked for exact
// equality. Here it is the smallest check that the card's int8 tensor-core
// sums are exact, and it runs the instruction and operand path that int8
// serving runs in every convolution of K3 (conv_i8.cu):
// wgmma.mma_async.m64n128k32.s32.s8.s8 with A from registers and B through
// a shared-memory descriptor with the 128-byte swizzle (wgmma.cuh). int8
// serving runs it once when it builds its forward on a card
// (ops/int8_gemm.py: check_int8_exact).
//
// What it computes. a (M, K) int8 row-major, b (K, N) int8 row-major,
// out (M, N) int32 = a @ b, exact. K % 32 == 0 and N % 8 == 0, any M.
//
// What bounds it on this card. At the probe's shape it moves 0.28 MB in and
// 1.05 MB out for 67 M int8 ops, ~50 ops per byte, far under the ~590 ridge
// of an H100 SXM: bound by bytes, 0.4 us at 3.35 TB/s. At that size one
// launch is launch latency; its speed matters little, since it runs once
// per forward build.
//
// Design. A block is one warpgroup and computes a 64 x 128 tile of the
// output (the probe's shape is 32 blocks). K is walked in chunks of 128
// bytes, the probe's whole K in one: the block stages b's chunk K-major,
// as wgmma wants an 8-bit B (it has no transposed form): each thread reads
// four rows of four columns as 32-bit words and transposes the 4 x 4 bytes
// in registers (__byte_perm) into four K-contiguous words, stored with the
// 128-byte swizzle into one 16 KB slab (17 KB of static shared memory with
// the slack that aligns it to 1024 bytes); columns past N are zeros. Each
// warp loads its 16 rows of a's chunk straight from global memory into the
// A registers of the chunk's four k-steps (rows past M are zeros), then the
// warpgroup issues the four wgmma and waits. Rows past M and columns past
// N are masked at the store.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "wgmma.cuh"

namespace {

using namespace wgmma;

constexpr int BM = 64, BN = 128, KC = 128;  // KC: bytes of K per chunk (one swizzle row)
constexpr int THREADS = 128;
constexpr int STEPS = KC / 32;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(1024) uint8_t s_raw[BN * KC + 1024];
  // the swizzle's 1024-byte atoms need a 1024-byte-aligned shared address
  uint8_t* s_b = s_raw + ((1024 - static_cast<uint32_t>(__cvta_generic_to_shared(s_raw))) & 1023);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + 16 * warp + g, r1 = r0 + 8;  // this thread's rows of A and D
  const uint32_t s_b_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(s_b));

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kcs = min(KC, K - k0);  // a multiple of 32
    __syncthreads();  // the previous chunk's wgmma have read s_b
    // b: rows k..k+3 of columns n..n+3 per item, transposed in registers
    // to four K-contiguous words (N % 8 keeps a quad all inside or all
    // outside)
    for (int i = tid; i < (kcs / 4) * (BN / 4); i += THREADS) {
      const int kk = 4 * (i / (BN / 4)), n = 4 * (i % (BN / 4));
      uint32_t r[4] = {0, 0, 0, 0};
      if (n0 + n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = ld32(b + (size_t)(k0 + kk + j) * N + n0 + n);
      }
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = n + j;  // swizzled: 16-byte piece kk / 16 of row `row`
        *reinterpret_cast<uint32_t*>(s_b + row * KC + (((kk >> 4) ^ (row & 7)) << 4) + (kk & 15)) =
            col[j];
      }
    }
    fence_proxy_async();
    __syncthreads();

    // A: a0 = row g, bytes 4t..; a1 = row g + 8; a2, a3 the same 16 bytes on
    uint32_t af[STEPS][4];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int k = k0 + 32 * s + 4 * t;
      const bool in = 32 * s < kcs;
      af[s][0] = in && r0 < M ? ld32(a + (size_t)r0 * K + k) : 0u;
      af[s][1] = in && r1 < M ? ld32(a + (size_t)r1 * K + k) : 0u;
      af[s][2] = in && r0 < M ? ld32(a + (size_t)r0 * K + k + 16) : 0u;
      af[s][3] = in && r1 < M ? ld32(a + (size_t)r1 * K + k + 16) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      if (32 * s < kcs) wgmma_m64n128k32_s8(acc, af[s], desc_sw128(s_b_u32) + 2 * s);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(acc[i]);
  }

  // acc[4j + 2*half + e]: row r0 + 8*half, column n0 + 8j + 2t + e
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < N)
        *reinterpret_cast<int2*>(out + (size_t)row * N + col) =
            make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace

extern "C" {

// Shapes and alignment are checked by the Python wrapper. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int int8_gemm(int device, const void* a, const void* b, void* out, int M, int N, int K,
              void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
