// The bf16 dense-block level at C % 128 != 0 (the model's C = 32, and any
// other C % 32 == 0) as a persistent implicit GEMM on wgmma fed by TMA, for
// Hopper (sm_90a). K2 (dense_block.cu) reaches it through
// dense_level_bf16.cuh, which owns the epilogue; C % 128 == 0 takes
// conv3x3_wgmma.cuh instead.
//
// Replaces: ops/pallas_rrdb.py::dense_block_pallas of the JAX package (body
// _make_dense_block_kernel), per level: the SAME 3x3 convolution of the
// concat prefix [0, k*C) into C channels that the TPU body computes in VMEM.
// The fused five-level form does not fit a block (dense_block.cu), so the
// level is one launch over the NHWC concat buffer.
//
// What bounds it. At the serving shape (2, 416, 416, 32) the five levels
// move 0.509 GB through device memory (0.152 ms at 3.35 TB/s) for 95.7
// GFLOP (0.097 ms at 989 TFLOP/s): 190 FLOP per byte, under the bf16 ridge
// of ~295, so the five launches are bound by their bytes. Inside a block the
// narrow N = 32 makes shared memory the next limit: each m64n32k16 reads
// 1 KB of weights through its descriptor and, with the row reuse below,
// 1 KB of halo through ldmatrix for its A fragments, about 128 bytes a
// cycle at the tensor cores' rate, which is all a block's shared memory
// gives. Levels 1-3 carry little work per byte, so there the epilogue's
// stores and each launch's start weigh most (chip_smoke.py prints the time
// of each level).
//
// GEMM view and design. M = output pixels, N = 32 output channels (one
// "group"; C / 32 groups), K = 9 taps x cin. A work item is one 16 x 16
// pixel tile (M = 256) of one image for one group.
// * Persistent grid: one block per SM (3 warpgroups, 384 threads) walks the
//   items blockIdx.x, + gridDim.x, ...; its two consumer warpgroups take
//   them in turn (ping-pong), so one's epilogue overlaps the other's
//   products.
// * Producer: one thread of warpgroup 2 (setmaxnreg 40) issues every TMA
//   load, the block's items in order, and waits on mbarriers. Each consumer
//   warpgroup has a ring of its own (RING slots), so each ring has exactly
//   one reader, in order.
//   - Weights, packed (9, C, cin) (input channels contiguous: K-major per
//     output channel, as wgmma's B wants), as 3-D boxes (32 ch, 32 out, 9
//     taps) = 18,432 B per 32-channel chunk. At C = 32 (one group) the
//     level's whole slice, cin / 32 <= 5 chunks (at most 92,160 B), is loaded
//     once per block and stays resident; at any other C the items change
//     group, so each ring slot carries its chunk's weights beside the halo.
//   - Activations: one (16+2) x (16+2) px x 32-channel halo box per chunk,
//     a 4-D box at (c0, x0-1, y0-1, b); TMA fills its out-of-image elements
//     with zeros, negative coordinates included, which is SAME padding.
//   Both with the 64-byte swizzle: a chunk is 32 bf16 = 64 bytes, which the
//   128-byte swizzle of conv3x3_wgmma.cuh (64-channel chunks) would not
//   divide at cin = 32, 96 or 160.
// * Consumers (setmaxnreg 232): each warp owns 4 consecutive tile rows,
//   m-block mb of the warpgroup being row 4 * warp + mb of each warp, so
//   that a tap's shift by dy rows reuses the fragments of another m-block:
//   per (chunk, dx, k16 step) a warp loads the 6 halo rows its 4 output rows
//   touch (ldmatrix from the swizzled halo: a tap's shift by whole pixels
//   does not line up with a descriptor's 8-row core matrices, so A goes
//   through registers) and issues 12 wgmma.mma_async.m64n32k16 bf16 -> f32
//   (3 dy x 4 m-blocks), B through a shared-memory descriptor of the
//   (tap, chunk) weight slice; 4 x 16 f32 accumulators per thread. One
//   group of 12 stays in flight while the next group's A loads.
// * The epilogue is the caller's functor per pair of channels
//   (dense_level_bf16.cuh: Epilogue), called so that the warp's stores fill
//   whole 32-byte sectors (shuffles move each lane's pairs into place) and,
//   for a tile inside the image, with no branch; a ragged tile's pixels
//   outside the image are masked.
// What it does about the mma.sync tile it replaces (16 x 16 px x 32 ch,
// one cp.async stage per chunk behind a full barrier, the level's weights
// restaged by each of 1,352 blocks, 5.1 waves):
// 1. loads overlap the math: the producer keeps RING chunks in flight per
//    consumer while the other consumer multiplies;
// 2. the weights are read from L2 once per block (132 times a launch, not
//    1,352) at C = 32;
// 3. wgmma reads B once per warpgroup instead of every warp loading its own
//    fragments, and the row reuse halves the ldmatrix traffic of A;
// 4. 1,352 tiles at the serving shape on 132 blocks of two consumers: no
//    wave quantisation beyond the last item of each block.
//
// Shared memory (dynamic), aligned to 1024 bytes: the resident weights
// (5 x 18,432 B at C = 32, none otherwise), 2 x RING slots of one halo box
// (20,736 B rounded to 20,992) plus, when streamed, its chunk's weights,
// and the mbarriers: 219,240 B resident, 158,792 B streamed.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "conv3x3_wgmma.cuh"  // ldmatrix_x4
#include "tma.cuh"
#include "wgmma.cuh"

namespace conv3x3_wgmma32 {

using namespace tma;
using conv3x3_wgmma::ldmatrix_x4;
using wgmma::keep;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int TH = 16, TW = 16;  // output tile rows x columns (M = 256)
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int BN = 32;           // output channels per item (N)
constexpr int KC = 32;           // input channels per chunk
constexpr int ROW = KC * 2;      // bytes per staged pixel or weight row: one 64-byte swizzle row
constexpr int HALO_BYTES = HALO_H * HALO_W * ROW;            // 20,736 B
constexpr int HALO_SLOT = (HALO_BYTES + 511) / 512 * 512;  // 20,992 B: whole 64-byte swizzle atoms
constexpr int W_TAP = BN * ROW;                              // 2,048 B: one (tap, chunk)
constexpr int W_CHUNK = 9 * W_TAP;                           // 18,432 B: one chunk's 9 taps
constexpr int MAX_RESIDENT_CHUNKS = 5;                       // cin <= 160: level 5 at C = 32
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);

// STREAM: the weights come with each chunk through the rings (C > 32)
// rather than resident (C = 32).
template <bool STREAM>
struct Cfg {
  static constexpr int RING = STREAM ? 2 : 3;  // slots per consumer warpgroup
  static constexpr int SLOT = HALO_SLOT + (STREAM ? W_CHUNK : 0);
  static constexpr int W_RES = STREAM ? 0 : MAX_RESIDENT_CHUNKS * W_CHUNK;
  static constexpr int RING_OFF = W_RES;
  static constexpr int BAR_OFF = RING_OFF + CONSUMERS * RING * SLOT;
  static constexpr int BARS = 2 * CONSUMERS * RING + 1;  // full, empty, resident weights
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * BARS;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// Shared-memory descriptor of a K-major B slice with the 64-byte swizzle:
// rows of 64 bytes, 8-row atoms 512 bytes apart (SBO); the leading byte
// offset is unused for this layout. A k16 step advances the start address by
// 32 bytes, i.e. the descriptor by 2.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// d (64 rows x 32 f32, this thread's 16) += a (64 x 16 bf16 in registers,
// this warp's 16 rows) * B (16 x 32 through `desc`).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The halo pixel p's 16-byte piece `piece` (0..3) under the 64-byte swizzle:
// the piece index XORs with bits 7-8 of the byte offset, (p >> 1) & 3.
__device__ __forceinline__ uint32_t halo_addr(uint32_t halo, int p, int piece) {
  return halo + p * ROW + ((piece ^ ((p >> 1) & 3)) << 4);
}

// The A fragments of one (dx, k16 step kk) for the warp's 6 halo rows:
// a[h] holds halo row hrow0 + h. col is this lane's ldmatrix row pixel
// (0..15), khalf which 16-byte half of the step it addresses.
__device__ __forceinline__ void load_a(uint32_t (&a)[6][4], uint32_t halo, int hrow0, int col,
                                       int khalf, int dx, int kk) {
#pragma unroll
  for (int h = 0; h < 6; ++h)
    ldmatrix_x4(a[h], halo_addr(halo, (hrow0 + h) * HALO_W + col + dx, 2 * kk + khalf));
}

struct Item {
  int b, y0, x0, n0;
};

__device__ __forceinline__ Item item_at(int item, int tiles, int tiles_x, int tiles_y) {
  const int group = item / tiles, t = item % tiles;
  const int per_image = tiles_x * tiles_y;
  const int r = t % per_image;
  return {t / per_image, (r / tiles_x) * TH, (r % tiles_x) * TW, group * BN};
}

// in_map: the (B, H, W, cin) prefix of the concat buffer, box (32, 18, 18,
// 1); w_map: the packed (9, cout, cin) weights, box (32, 32, 9); both with
// the 64-byte swizzle. `tiles` = B * tiles_y * tiles_x, `items` = tiles *
// cout / 32. For every output pixel `pix` (flat index b*H*W + y*W + x) and
// even output channel n, the epilogue gets epi(pix, n, acc[n], acc[n + 1]).
template <bool STREAM, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma32_kernel(const __grid_constant__ CUtensorMap in_map,
                       const __grid_constant__ CUtensorMap w_map, int H, int W, int chunks,
                       int tiles_x, int tiles_y, int tiles, int items, Epi epi) {
  using C = Cfg<STREAM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = base + C::RING_OFF;
  const uint32_t bars = base + C::BAR_OFF;
  // slot s of consumer w's ring
  const auto slot = [&](int w, int s) { return ring + (w * C::RING + s) * C::SLOT; };
  const auto full = [&](int w, int s) { return bars + 8 * (w * C::RING + s); };
  const auto empty = [&](int w, int s) { return bars + 8 * (CONSUMERS * C::RING + w * C::RING + s); };
  const uint32_t w_full = bars + 8 * (2 * CONSUMERS * C::RING);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < CONSUMERS * C::RING; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (CONSUMERS * C::RING + i), 1);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Consumer w's j-th item (j = 0, 1, ...: the block's items 2j + w) takes
  // its ring's stages q = j * chunks + c, slot q % RING, in round q / RING.
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      if constexpr (!STREAM) {
        mbar_expect_tx(w_full, chunks * W_CHUNK);
        for (int c = 0; c < chunks; ++c)
          tma_load_3d(base + c * W_CHUNK, &w_map, w_full, c * KC, 0, 0);
      }
      // the block's items in order, item i to consumer i % 2 as its (i / 2)-th
      int i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++i) {
        const int w = i & 1, j = i >> 1;
        const Item it = item_at(item, tiles, tiles_x, tiles_y);
        for (int c = 0; c < chunks; ++c) {
          const int q = j * chunks + c, s = q % C::RING;
          mbar_wait(empty(w, s), ((q / C::RING) & 1) ^ 1);
          const uint32_t dst = slot(w, s);
          mbar_expect_tx(full(w, s), C::SLOT - HALO_SLOT + HALO_BYTES);
          tma_load_4d(dst, &in_map, full(w, s), c * KC, it.x0 - 1, it.y0 - 1, it.b);
          if constexpr (STREAM)
            tma_load_3d(dst + HALO_SLOT, &w_map, full(w, s), c * KC, it.n0, 0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    // ldmatrix x4: lanes 8i..8i+7 address the rows of matrix i: pixels 0-7
    // (i even) or 8-15 (i odd) of a tile row, 16-byte half i / 2 of the step
    const int col = (lane & 7) + (lane & 8), khalf = lane >> 4;
    const int hrow0 = 4 * warp;  // the warp's output rows 4w..4w+3 read halo rows 4w..4w+5
    const bool elected = (threadIdx.x & 127) == 0;
    if constexpr (!STREAM) mbar_wait(w_full, 0);

    int j = 0;
    for (int item = blockIdx.x + wg * gridDim.x; item < items; item += 2 * gridDim.x, ++j) {
      const Item it = item_at(item, tiles, tiles_x, tiles_y);
      float acc[4][16];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[mb][i] = 0.f;
      uint32_t a[2][6][4];  // [group parity][halo row][register]

      const int q0 = j * chunks;
      mbar_wait(full(wg, q0 % C::RING), (q0 / C::RING) & 1);
      load_a(a[0], slot(wg, q0 % C::RING), hrow0, col, khalf, 0, 0);
      for (int c = 0; c < chunks; ++c) {
        const int q = q0 + c, s = q % C::RING;
        const uint32_t halo = slot(wg, s);
        const uint32_t wbase = STREAM ? halo + HALO_SLOT : base + c * W_CHUNK;
#pragma unroll
        for (int g = 0; g < 6; ++g) {  // g = 2 * dx + kk
          const int dx = g >> 1, kk = g & 1;
#pragma unroll
          for (int mb = 0; mb < 4; ++mb)
#pragma unroll
            for (int i = 0; i < 16; ++i) keep(acc[mb][i]);
          wgmma_fence();
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint64_t desc = desc_sw64(wbase + (dy * 3 + dx) * W_TAP) + 2 * kk;
#pragma unroll
            for (int mb = 0; mb < 4; ++mb) wgmma_m64n32k16(acc[mb], a[g & 1][mb + dy], desc);
          }
          wgmma_commit();
          // the previous group is done: its A registers are free, and at a
          // chunk's first group the previous chunk's slot goes back
          wgmma_wait<1>();
#pragma unroll
          for (int h = 0; h < 6; ++h)
#pragma unroll
            for (int r = 0; r < 4; ++r) keep(a[(g + 1) & 1][h][r]);
          if (g == 0 && c > 0 && elected) mbar_arrive(empty(wg, (q - 1) % C::RING));
          if (g < 5) {
            load_a(a[(g + 1) & 1], halo, hrow0, col, khalf, (g + 1) >> 1, (g + 1) & 1);
          } else if (c + 1 < chunks) {
            const int qn = q + 1;
            mbar_wait(full(wg, qn % C::RING), (qn / C::RING) & 1);
            load_a(a[0], slot(wg, qn % C::RING), hrow0, col, khalf, 0, 0);
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int i = 0; i < 16; ++i) keep(acc[mb][i]);
      if (elected) mbar_arrive(empty(wg, (q0 + chunks - 1) % C::RING));

      // acc[mb][4n + 2*half + e] is pixel (row 4*warp + mb, column lane/4 +
      // 8*half) of the tile, channel n0 + 8n + 2*(lane%4) + e. Each call of
      // the epilogue across the warp takes 4 pixels x 16 channels instead,
      // lane L pixel 4*(i/2) + L/8 and channels 16*(i%2) + 2*(L%8) + e, moved
      // there by shuffles: its stores then fill whole 32-byte sectors. A tile
      // inside the image runs with no branch, so the epilogue's loads (bias,
      // residual) issue together.
      const auto store = [&](auto inside_tag) {
        constexpr bool INSIDE = decltype(inside_tag)::value;
        const int cp = lane & 7, src_t = cp & 3, upper = cp >> 2;
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          const int y = it.y0 + hrow0 + mb;
          if (!INSIDE && y >= H) continue;
          const size_t row = ((size_t)it.b * H + y) * W;
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int sec = i & 1, px = 4 * (i >> 1) + (lane >> 3), src = 4 * px + src_t;
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float lo = __shfl_sync(0xffffffffu, acc[mb][8 * sec + 2 * half + e], src);
                const float hi = __shfl_sync(0xffffffffu, acc[mb][8 * sec + 4 + 2 * half + e], src);
                v[e] = upper ? hi : lo;
              }
              const int x = it.x0 + 8 * half + px;
              if (INSIDE || x < W) epi(row + x, it.n0 + 16 * sec + 2 * cp, v[0], v[1]);
            }
        }
      };
      if (it.y0 + TH <= H && it.x0 + TW <= W)
        store(std::true_type{});
      else
        store(std::false_type{});
    }
  }
}

// The form a level takes: the weights resident at one group (C = 32) when
// the level's slice fits, else streamed with each chunk.
inline bool resident(int cin, int cout) {
  return cout == BN && cin / KC <= MAX_RESIDENT_CHUNKS;
}

// Dynamic shared memory of a block for a level of cin -> cout channels.
inline int smem_bytes(int cin, int cout) {
  return resident(cin, cout) ? Cfg<false>::SMEM : Cfg<true>::SMEM;
}

template <bool STREAM, class Epi>
int go(const CUtensorMap& in_map, const CUtensorMap& w_map, int B, int H, int W, int cin,
       int cout, Epi epi, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma32_kernel<STREAM, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<STREAM>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int tiles = B * tiles_x * tiles_y, items = tiles * (cout / BN);
  const int grid = items < sms ? items : sms;
  kernel<<<grid, THREADS, Cfg<STREAM>::SMEM, stream>>>(in_map, w_map, H, W, cin / KC, tiles_x,
                                                       tiles_y, tiles, items, epi);
  return static_cast<int>(cudaGetLastError());
}

// buf: NHWC bf16, buf_stride elements between pixels, read over channels
// [0, cin); w: packed (9, cout, cin) bf16. Needs cin % 32 == 0, cout % 32 ==
// 0, and what TMA needs: 16-byte-aligned base addresses and pixel stride
// (the Python wrappers check these and raise; here they return
// cudaErrorInvalidValue / cudaErrorMisalignedAddress). Launches on `stream`
// and returns the cudaError_t of the launch.
template <class Epi>
int launch(const void* buf, int B, int H, int W, int buf_stride, int cin, const void* w,
           int cout, Epi epi, cudaStream_t stream) {
  if (cin % KC || cout % BN || cin > buf_stride || cin <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(buf) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      (buf_stride * 2) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t px = static_cast<cuuint64_t>(buf_stride) * 2;  // bytes per pixel
  const cuuint64_t in_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                                 static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t in_strides[3] = {px, px * W, px * W * H};
  const cuuint32_t in_box[4] = {KC, HALO_W, HALO_H, 1};
  CUtensorMap in_map, w_map;
  if (encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(buf), in_dims,
             in_strides, in_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout), 9};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(cin) * 2 * cout};
  const cuuint32_t w_box[3] = {KC, BN, 9};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), w_dims,
             w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (resident(cin, cout)) return go<false>(in_map, w_map, B, H, W, cin, cout, epi, stream);
  return go<true>(in_map, w_map, B, H, W, cin, cout, epi, stream);
}

}  // namespace conv3x3_wgmma32
