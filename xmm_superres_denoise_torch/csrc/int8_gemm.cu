// P: an s8 x s8 -> s32 matrix product on the tensor cores, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces: the probe `kernel` of scripts/device_probe_pallas_int8.py of
// the JAX repository, a Pallas TPU kernel that multiplies (2048, 128) by
// (128, 128) int8 with int32 accumulation and is checked for exact
// equality. Here it is the smallest check that the card's int8 tensor-core
// sums are exact, on the warp tile (mma_tile.cuh) that the s8 convolution
// K3 (conv_i8.cu) is built on.
//
// What it computes. a (M, K) int8 row-major, b (K, N) int8 row-major,
// out (M, N) int32 = a @ b, exact. K % 32 == 0 and N % 8 == 0.
//
// What bounds it on this card. At the probe's shape it moves 0.28 MB in and
// 1.05 MB out for 67 M int8 ops, ~50 ops per byte, far under the ~590 ridge
// of an H100 SXM: bound by bytes, 0.4 us at 3.35 TB/s. At that size one
// launch is launch latency: the time from the launch to the last block's
// stores, set by how many blocks run side by side and how long each one's
// serial chain of loads, k-steps and stores is.
//
// Design, shaped for that latency. A block computes a 64 x 64 tile of the
// output with 4 warps, 2 along M by 2 along N, each a 32 x 32 mma_tile warp
// tile (mma.sync m16n8k32 s8 -> s32, N_TILES = 4), so the probe's shape is
// 32 x 2 = 64 blocks on 64 of the card's 132 SMs (a 128 x 128 tile gave 16).
// K is walked in chunks of 128 bytes, the probe's whole K in one: the block
// stages its 64 rows of a with cp.async and its 64 columns of b
// K-contiguous, each thread reading four rows of b as 32-bit words and
// transposing the 4 x 4 bytes in registers (__byte_perm) into four 32-bit
// stores; both into rows of 144 bytes, 18,432 B of static shared memory.
// ptxas (nvcc 12.8, sm_90a): 70 registers, no spills.

#include "device_guard.cuh"
#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int BM = 64, BN = 64, KC = 128;
constexpr int N_TILES = 4;  // 32 x 32 warp tile
constexpr int WARP_N = 8 * N_TILES;
constexpr int WARPS_M = BM / WARP_M;
constexpr int ROW = KC + 16;
constexpr int THREADS = 32 * WARPS_M * (BN / WARP_N);

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint8_t s_a[BM * ROW];
  __shared__ __align__(16) uint8_t s_b[BN * ROW];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;

  S8::Acc acc[M_TILES][N_TILES][4];
  zero<S8, N_TILES>(acc);

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < BM * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), v = i % (KC / 16);
      const int row = m0 + r, k = k0 + 16 * v;
      const bool in = row < M && k < K;
      cp_async16(s_a + r * ROW + 16 * v, in ? a + (size_t)row * K + k : a, in ? 16 : 0);
    }
    // b: four rows k..k+3 of four columns n..n+3 per item, transposed in
    // registers to four K-contiguous words (K % 32 and N % 8 keep a quad
    // all inside or all outside)
    for (int i = tid; i < (KC / 4) * (BN / 4); i += THREADS) {
      const int kk = 4 * (i / (BN / 4)), n = 4 * (i % (BN / 4));
      const int k = k0 + kk;
      uint32_t r[4] = {0, 0, 0, 0};
      if (k < K && n0 + n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k + j) * N + n0 + n);
      }
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      uint8_t* col = s_b + n * ROW + kk;
      *reinterpret_cast<uint32_t*>(col) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(col + ROW) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(col + 2 * ROW) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(col + 3 * ROW) = __byte_perm(hi01, hi23, 0x7632);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += K_BYTES)
      kstep<S8, N_TILES>(acc, s_a + (wm * WARP_M + g) * ROW + ks + 4 * t, 8 * ROW, 16 * ROW,
                         s_b + (wn * WARP_N + g) * ROW + ks + 4 * t, 8 * ROW);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < M_TILES; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WARP_M + mi * 16 + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < N_TILES; ++ni) {
        const int col = n0 + wn * WARP_N + ni * 8 + 2 * t;
        if (col < N)
          *reinterpret_cast<int2*>(out + (size_t)row * N + col) =
              make_int2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
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
