// P: an s8 x s8 -> s32 matrix product on the tensor cores, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces: the probe `kernel` of scripts/device_probe_pallas_int8.py of
// the JAX repository, a Pallas TPU kernel that multiplies (2048, 128) by
// (128, 128) int8 with int32 accumulation and is checked for exact
// equality. Here it is the smallest check that the card's int8 tensor-core
// sums are exact, and the warp tile (mma_tile.cuh) that the s8 convolution
// K3 (conv_i8.cu) is built on.
//
// What it computes. a (M, K) int8 row-major, b (K, N) int8 row-major,
// out (M, N) int32 = a @ b, exact. K % 32 == 0 and N % 8 == 0.
//
// Design. A block computes a 128 x 128 tile of the output with 8 warps,
// 4 along M by 2 along N, each a 32 x 64 mma_tile warp tile
// (mma.sync m16n8k32 s8 -> s32). K is walked in chunks of 128 bytes: the
// block stages its 128 rows of a with cp.async and transposes its 128
// columns of b into K-contiguous rows while staging (the B fragment wants
// K-major columns), both into rows of 144 bytes; 36,864 B of static
// shared memory. ptxas (nvcc 12.8, sm_90a): 126 registers, no spills.
//
// What bounds it on this card. At the probe's shape it moves 0.28 MB in and
// 1.05 MB out for 67 M int8 ops, ~50 ops per byte, far under the ~590 ridge
// of an H100 SXM: bound by bytes, 0.4 us at 3.35 TB/s. At that size one
// launch is ~16 blocks and its time is launch latency.

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int BM = 128, BN = 128, KC = 128;
constexpr int ROW = KC + 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint8_t s_a[BM * ROW];
  __shared__ __align__(16) uint8_t s_b[BN * ROW];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % 4, wn = warp / 4;

  S8::Acc acc[M_TILES][N_TILES][4];
  zero<S8>(acc);

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < BM * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), v = i % (KC / 16);
      const int row = m0 + r, k = k0 + 16 * v;
      const bool in = row < M && k < K;
      cp_async16(s_a + r * ROW + 16 * v, in ? a + (size_t)row * K + k : a, in ? 16 : 0);
    }
    for (int i = tid; i < KC * (BN / 4); i += THREADS) {
      const int kk = i / (BN / 4), n = 4 * (i % (BN / 4));
      const int k = k0 + kk;
      char4 v = make_char4(0, 0, 0, 0);
      if (k < K && n0 + n < N)
        v = *reinterpret_cast<const char4*>(b + (size_t)k * N + n0 + n);
      s_b[(n + 0) * ROW + kk] = static_cast<uint8_t>(v.x);
      s_b[(n + 1) * ROW + kk] = static_cast<uint8_t>(v.y);
      s_b[(n + 2) * ROW + kk] = static_cast<uint8_t>(v.z);
      s_b[(n + 3) * ROW + kk] = static_cast<uint8_t>(v.w);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += K_BYTES)
      kstep<S8>(acc, s_a + (wm * WARP_M + g) * ROW + ks + 4 * t, 8 * ROW, 16 * ROW,
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
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
