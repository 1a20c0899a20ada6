// A SAME 3x3 convolution as an implicit GEMM on the tensor cores (mma.sync),
// NHWC: the s8 convolution's route at cin % 128 != 0 (conv_i8.cu), i.e.
// conv_first.
//
// GEMM view: M = output pixels, N = output channels, K = 9 taps x input
// channels. A block computes a TH x 16 pixel tile (M = 16 * TH) for BN
// output channels; its warps are TH / 2 along M (two tile rows each, one
// m16 tile per row) by BN / WARP_N along N, each a mma_tile warp tile of
// 32 x WARP_N. The tile shape is a template parameter (`Tile` below):
//   Tile128: TH = 8,  BN = 128, 8 warps of 32 x 64 (K3 at cin % 128 != 0,
//            i.e. conv_first; K3 at 128-channel multiples runs
//            conv3x3_wgmma.cuh instead)
// K is walked in chunks of CHUNK bytes of input channels: for each chunk the
// block stages
//   the (TH+2) x (16+2) input halo tile, CHUNK bytes per pixel, with zeros
//     outside the image (SAME padding), and
//   the weights of all 9 taps for its BN output channels, CHUNK bytes each,
// both with cp.async into rows of CHUNK + 16 bytes (bank-conflict free
// fragment loads, see mma_tile.cuh), then runs 9 taps x CHUNK/32 k-steps.
// A tap (dy, dx) of output pixel (r, c) reads staged pixel (r+dy, c+dx), so
// the GEMM's A operand is never materialised.
//
// Weights come packed once by the wrapper as (9, Cout, Cin): for each tap
// and output channel the input channels are contiguous, the K-major order
// that the B fragment of mma.sync row.col wants.
//
// Shared memory per block (dynamic):
//   Tile128, CHUNK = 32 (s8):   180 px * 48 B + 9 * 128 * 48 B =  8,640 + 55,296 =  63,936 B
// so two Tile128 blocks fit in an SM's shared memory.
#pragma once

#include "mma_tile.cuh"

namespace igemm {

using namespace mma_tile;

constexpr int TW = 16;  // output tile columns: one m16 tile per tile row
constexpr int HALO_W = TW + 2;
constexpr int PAD = 16;

template <int TH_, int BN_, int N_TILES_>
struct Tile {
  static constexpr int TH = TH_;                  // output tile rows
  static constexpr int BN = BN_;                  // output channels per block
  static constexpr int N_TILES = N_TILES_;        // n8 tiles per warp
  static constexpr int WARP_N = 8 * N_TILES;      // output channels per warp
  static constexpr int WARPS_M = TH / 2;          // two tile rows per warp
  static constexpr int WARPS_N = BN / WARP_N;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int HALO_PIX = (TH + 2) * HALO_W;
  static_assert(TH % 2 == 0 && BN % WARP_N == 0, "tile shape");
};

using Tile128 = Tile<8, 128, 8>;

// __launch_bounds__ asks for two blocks per SM, which lets ptxas use up to
// 128 registers.
constexpr int MIN_BLOCKS = 2;

template <class T, int CHUNK>
struct Geometry {
  static constexpr int ROW = CHUNK + PAD;
  static constexpr int IN_BYTES = T::HALO_PIX * ROW;
  static constexpr int SMEM = IN_BYTES + 9 * T::BN * ROW;
};

// src: NHWC with `src_stride` bytes between pixels; channels [0, cin_bytes)
// are read. w: packed (9, cout, cin_bytes). For every output pixel `pix`
// (flat index b*H*W + y*W + x) and even output channel n, the epilogue gets
// epi(pix, n, acc[n], acc[n + 1]).
template <class Op, int CHUNK, class T, class Epi>
__global__ void __launch_bounds__(T::THREADS, MIN_BLOCKS)
conv3x3_kernel(const uint8_t* src, int H, int W, int src_stride, int cin_bytes,
               const uint8_t* __restrict__ w, int cout, Epi epi) {
  using G = Geometry<T, CHUNK>;
  constexpr int VEC = CHUNK / 16;  // 16-byte copies per staged row
  constexpr int N_TILES = T::N_TILES;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_in = smem;
  uint8_t* s_w = smem + G::IN_BYTES;

  const int groups = cout / T::BN;
  const int b = blockIdx.z / groups;
  const int n0 = (blockIdx.z % groups) * T::BN;
  const int y0 = blockIdx.y * T::TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const size_t img = (size_t)b * H * W;

  typename Op::Acc acc[M_TILES][N_TILES][4];
  zero<Op, N_TILES>(acc);

  for (int c0 = 0; c0 < cin_bytes; c0 += CHUNK) {
    for (int i = tid; i < T::HALO_PIX * VEC; i += T::THREADS) {
      const int v = i % VEC, p = i / VEC;
      const int y = y0 - 1 + p / HALO_W, x = x0 - 1 + p % HALO_W;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const uint8_t* from =
          in ? src + (img + (size_t)y * W + x) * src_stride + c0 + 16 * v : src;
      cp_async16(s_in + p * G::ROW + 16 * v, from, in ? 16 : 0);
    }
    for (int i = tid; i < 9 * T::BN * VEC; i += T::THREADS) {
      const int v = i % VEC, r = i / VEC;  // r = tap * BN + n
      const int n = r % T::BN, tap = r / T::BN;
      cp_async16(s_w + r * G::ROW + 16 * v,
                 w + ((size_t)tap * cout + n0 + n) * cin_bytes + c0 + 16 * v, 16);
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint8_t* a = s_in + ((2 * wm + dy) * HALO_W + g + dx) * G::ROW + 4 * t;
      const uint8_t* bp = s_w + (tap * T::BN + wn * T::WARP_N + g) * G::ROW + 4 * t;
#pragma unroll
      for (int k = 0; k < CHUNK; k += K_BYTES)
        kstep<Op, N_TILES>(acc, a + k, 8 * G::ROW, HALO_W * G::ROW, bp + k, 8 * G::ROW);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < M_TILES; ++mi) {
    const int y = y0 + 2 * wm + mi;
    if (y >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = x0 + g + 8 * half;
      if (x >= W) continue;
      const size_t pix = img + (size_t)y * W + x;
#pragma unroll
      for (int ni = 0; ni < N_TILES; ++ni)
        epi(pix, n0 + wn * T::WARP_N + ni * 8 + 2 * t, acc[mi][ni][2 * half],
            acc[mi][ni][2 * half + 1]);
    }
  }
}

// Launch on `stream`; returns the cudaError_t of the launch. cout is a
// multiple of T::BN and cin_bytes of CHUNK.
template <class Op, int CHUNK, class T, class Epi>
int launch(const void* src, int B, int H, int W, int src_stride, int cin_bytes,
           const void* w, int cout, Epi epi, cudaStream_t stream) {
  auto kernel = conv3x3_kernel<Op, CHUNK, T, Epi>;
  constexpr int smem = Geometry<T, CHUNK>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + T::TH - 1) / T::TH, B * (cout / T::BN));
  kernel<<<grid, T::THREADS, smem, stream>>>(static_cast<const uint8_t*>(src), H, W,
                                             src_stride, cin_bytes,
                                             static_cast<const uint8_t*>(w), cout, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace igemm
