// The f32 dense-block level for Hopper's CUDA cores (sm_90a): a SAME 3x3
// cross-correlation over the concat prefix in f32 products and f32 sums,
// then the level's epilogue. K2 (dense_block.cu) launches it for every f32
// level at any C % 32 == 0, and K1's f32 levels (ops/dense_block_s2d.py)
// reach it through K2's library.
//
// Replaces, per level, the f32 bodies of two Pallas TPU kernels of the JAX
// package: ops/pallas_rrdb.py::dense_block_pallas (K2, body
// _make_dense_block_kernel) and ops/pallas_dense_block.py::
// dense_block_s2d_pallas (K1, body _make_kernel). Both keep the 5-level
// concat in VMEM; here it stays one NHWC buffer in device memory and the
// level is one launch (dense_block.cu says why).
//
// What it computes. buf is the (B, H, W, stride) concat buffer; level k
// reads channels [0, cin = k*C) and w is HWIO (3, 3, cin, C). For each
// output pixel and channel: v = sum over taps and input channels of
// in * w (fmaf, f32), then v += bias;
//   residual == 0 (k < 5): LeakyReLU(0.2), stored to dst (buffer channels
//                          [k*C, (k+1)*C));
//   residual != 0 (k = 5): v * 0.2f + x, with x = buffer channels [0, C),
//                          stored to the output.
// There is no TF32 and no tensor-core instruction on this path: every
// product is an FFMA.
//
// What bounds it. 2 * 9 * cin * C FLOP per pixel: 95.7 GFLOP per 5-level
// block at (2, 416, 416, 32) and 382.8 GFLOP as computed at
// (2, 208, 208, 128) (the S2D weights' structural zeros included), against
// 23 * C values per pixel of five-launch traffic: bound by operations,
// 1.428 ms and 5.713 ms at the 67 TFLOP/s FP32 peak (3.35 TB/s would move
// that traffic, 1.02 GB at either shape, in 0.30 ms). So the kernel is a
// question of how many of the SM's issue slots are FFMAs.
//
// Design, against the three things that held the previous kernel (a
// synchronous 16x16 px x 32 ch block, 2.05 waves) to 28-33 % of the bound:
// 1. Asynchronous staging by TMA. Input channels are walked in chunks of
//    CK (8 at CO = 32, 16 at CO = 128). One thread issues a chunk's copies
//    (cp.async.bulk.tensor, tma.cuh): CK / 4 boxes of (4 channels, 18
//    columns, TH + 2 rows) of the halo and one box of the weights,
//    HWIO read as (cout, cin, 9), box (CO, CK, 9). They land in a ring of
//    STAGES = 2 buffers and complete on an mbarrier each, so chunk i+1
//    loads while chunk i's FFMAs run; one __syncthreads per chunk hands a
//    buffer back. TMA fills the halo's out-of-image elements, negative
//    coordinates included, with zeros: SAME padding with no bounds code.
//    The halo stays the dense box TMA writes, [row][column][4 channels]:
//    the threads are laid out so that each quarter-warp reads 8
//    consecutive pixels of one halo row, 128 contiguous bytes, with
//    LDS.128, which no padding or swizzle needs to make conflict free.
// 2. One block per pixel tile for all its output channels, up to CO = 128:
//    at C % 128 == 0 a block covers TH x 16 px x 128 ch (512 threads, one
//    block per SM), so a tile's halo is staged once, not once per 32
//    channels; otherwise TH x 16 px x 32 ch (128 threads, four blocks per
//    SM). The grid is persistent: SMs x resident blocks, each block walking
//    tiles blockIdx.x, + gridDim.x, ... as one stream of (tile, chunk)
//    items, so the next tile's first chunk loads during this tile's last
//    FFMAs and epilogue.
// 3. A register tile that reuses both operands. A warp owns 8 output
//    channels of the whole tile: lane = (column 0-15, run 0-1), each
//    thread RUN consecutive rows of one column. Per (4-channel quad, dx) a
//    thread loads one column window of RUN + 2 halo pixels (RUN + 2
//    LDS.128, which feed all three dy taps) and, per (channel, dy), one
//    weight row of 8 channels (2 LDS.128 at the same address in every
//    lane: a broadcast), for 4 * 3 * RUN * 8 FFMAs on RUN * 8
//    accumulators: 480 FFMAs per 31 shared loads at RUN = 5, 672 per 33
//    at RUN = 7. At most 128 registers a thread (__launch_bounds__),
//    which four 128-thread blocks or one 512-thread block per SM fill.
// 4. Full rounds. The tile height TH = 2 * RUN is chosen for the tile
//    count of the serving shapes: 10 x 16 px tiles at (2, 416, 416, 32)
//    are 2184 tiles, 16.5 per SM in four blocks (16 x 16 px: 10.24, the
//    busiest SMs idle a tenth of the last round); 14 x 16 px tiles at
//    (2, 208, 208, 128) are 390 tiles, 2.95 per one-block SM (16 x 16 px:
//    338 = 2.56, 44 % of the SMs idle in the third round).
// Shared memory (dynamic): 2 stages of halo and weights, the mbarriers and
// 128 B of alignment: 32,400 B at CO = 32, 184,464 B at CO = 128. ptxas
// (sm_90a): 128 registers at both widths, no spills; the SASS holds FFMA
// and no HMMA or HGMMA (a card test checks it).
#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace conv3x3_f32 {

using namespace tma;

constexpr int TW = 16, HALO_W = TW + 2;  // output tile columns: one per lane of a half-warp
constexpr int CPT = 8;                   // output channels of a thread (one warp's)
constexpr int STAGES = 2;

// CO output channels per block; a thread owns RUN consecutive rows of one
// column, a warp 16 columns x 2 runs = a TH = 2 * RUN row tile for 8
// channels. RUN is set by what the tile count does to the last round at
// the serving shapes (the note at the top).
template <int CO>
struct Cfg {
  static constexpr int THREADS = 32 * (CO / CPT);  // one warp per 8 output channels
  static constexpr int RUN = CO == 32 ? 5 : 7;
  static constexpr int TH = 2 * RUN, HALO_H = TH + 2;
  static constexpr int CK = CO == 32 ? 8 : 16;  // input channels per chunk
  static constexpr int QUADS = CK / 4;
  static constexpr int QUAD_BOX = HALO_H * HALO_W * 16;  // one TMA box: 4 channels of the halo
  static constexpr int QUAD_SLOT = (QUAD_BOX + 127) / 128 * 128;  // TMA writes 128-byte aligned
  static constexpr int ACT_BYTES = QUADS * QUAD_SLOT;
  static constexpr int W_BYTES = 9 * CK * CO * 4;  // [tap][ci][CO]
  static constexpr int STAGE = ACT_BYTES + W_BYTES;
  static constexpr int TX_BYTES = QUADS * QUAD_BOX + W_BYTES;  // what one chunk's copies write
  static constexpr int SMEM = 128 + STAGES * STAGE + 8 * STAGES;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // <= 128 registers
  static_assert(STAGE % 128 == 0, "stage alignment");
};

struct Tile {
  int b, y0, x0, n0;
};

// Tile t in (b, tile row, tile column, channel group) order, the group
// fastest; tiles of th x TW pixels and co channels.
__device__ __forceinline__ Tile tile_at(int t, int groups, int tiles_x, int tiles_y, int th,
                                        int co) {
  const int g = t % groups;
  t /= groups;
  const int tx = t % tiles_x;
  t /= tiles_x;
  return {t / tiles_y, (t % tiles_y) * th, tx * TW, g * co};
}

// in_map: the (B, H, W, cin) prefix of the f32 concat buffer, box
// (4, 18, TH + 2, 1); w_map: the HWIO weights as (cout, cin, 9), box (CO, CK, 9).
// buf (for the level-5 residual) and dst may be the same buffer (disjoint
// channels), so neither is __restrict__.
template <int CO>
__global__ void __launch_bounds__(Cfg<CO>::THREADS, Cfg<CO>::MIN_BLOCKS)
conv3x3_f32_kernel(const __grid_constant__ CUtensorMap in_map,
                   const __grid_constant__ CUtensorMap w_map, const float* buf, int H, int W,
                   int stride, int cin, const float* __restrict__ bias, int cout, float* dst,
                   int dst_stride, int residual, int tiles_x, int tiles_y, int tiles) {
  using C = Cfg<CO>;
  constexpr int CK = C::CK, RUN = C::RUN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  const uint32_t bars = smem_u32(smem + STAGES * C::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int col = lane & 15, row0 = (lane >> 4) * RUN;
  const int groups = cout / CO, chunks = cin / CK;
  const int items = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * chunks;
  const auto tile_of = [&](int item) {
    return tile_at(blockIdx.x + item / chunks * gridDim.x, groups, tiles_x, tiles_y, C::TH, CO);
  };
  // one thread stages item `item`: CK channels of its tile's halo as
  // QUADS boxes of 4 channels, and the weights of those channels
  const auto issue = [&](int item) {
    const Tile tl = tile_of(item);
    const int c0 = item % chunks * CK, s = item % STAGES;
    const uint32_t dst_s = smem_u32(smem + s * C::STAGE), bar = bars + 8 * s;
    mbar_expect_tx(bar, C::TX_BYTES);
#pragma unroll
    for (int qd = 0; qd < C::QUADS; ++qd)
      tma_load_4d(dst_s + qd * C::QUAD_SLOT, &in_map, bar, c0 + 4 * qd, tl.x0 - 1, tl.y0 - 1, tl.b);
    tma_load_3d(dst_s + C::ACT_BYTES, &w_map, bar, tl.n0, c0, 0);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES - 1 && s < items; ++s) issue(s);

  float acc[RUN][CPT];
#pragma unroll
  for (int p = 0; p < RUN; ++p)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[p][c] = 0.f;

  for (int item = 0; item < items; ++item) {
    if (item > 0) __syncthreads();  // every thread is done with the stage reloaded next
    if (tid == 0 && item + STAGES - 1 < items) issue(item + STAGES - 1);
    mbar_wait(bars + 8 * (item % STAGES), (item / STAGES) & 1);

    const uint8_t* s = smem + item % STAGES * C::STAGE;
    const float4* a_col = reinterpret_cast<const float4*>(s) + row0 * HALO_W + col;
    const float4* w_grp = reinterpret_cast<const float4*>(s + C::ACT_BYTES) + grp * (CPT / 4);
#pragma unroll 1
    for (int qd = 0; qd < C::QUADS; ++qd) {
#pragma unroll 1
      for (int dx = 0; dx < 3; ++dx) {
        // the column of RUN + 2 halo pixels that output rows row0 ..
        // row0 + RUN - 1 read at taps (0..2, dx): 4 channels each
        const float4* a_p = a_col + qd * (C::QUAD_SLOT / 16) + dx;
        float4 a[RUN + 2];
#pragma unroll
        for (int i = 0; i < RUN + 2; ++i) a[i] = a_p[i * HALO_W];
        const float4* w_p = w_grp + (dx * CK + 4 * qd) * (CO / 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float4* wr = w_p + (dy * 3 * CK + j) * (CO / 4);
            const float4 w0 = wr[0], w1 = wr[1];
            const float wv[CPT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int p = 0; p < RUN; ++p) {
              const float4& q = a[p + dy];
              const float av = j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
#pragma unroll
              for (int c = 0; c < CPT; ++c) acc[p][c] = fmaf(av, wv[c], acc[p][c]);
            }
          }
      }
    }

    if (item % chunks == chunks - 1) {  // the tile's last chunk: epilogue
      const Tile tl = tile_of(item);
      const int x = tl.x0 + col, n = tl.n0 + grp * CPT;
      float bv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) bv[c] = __ldg(bias + n + c);
#pragma unroll
      for (int p = 0; p < RUN; ++p) {
        const int y = tl.y0 + row0 + p;
        if (y < H && x < W) {
          const size_t pix = (size_t)(tl.b * H + y) * W + x;
          float o[CPT];
          if (residual) {
            const float4* r = reinterpret_cast<const float4*>(buf + pix * stride + n);
            const float4 r0 = r[0], r1 = r[1];
            const float rv[CPT] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
            for (int c = 0; c < CPT; ++c) o[c] = (acc[p][c] + bv[c]) * 0.2f + rv[c];
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const float v = acc[p][c] + bv[c];
              o[c] = v >= 0.f ? v : 0.2f * v;
            }
          }
          float4* d = reinterpret_cast<float4*>(dst + pix * dst_stride + n);
          d[0] = make_float4(o[0], o[1], o[2], o[3]);
          d[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
      }
#pragma unroll
      for (int p = 0; p < RUN; ++p)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[p][c] = 0.f;
    }
  }
}

template <int CO>
int launch_co(const void* buf, int B, int H, int W, int stride, int cin, const void* w,
              const float* bias, int cout, float* dst, int dst_stride, int residual,
              cudaStream_t stream) {
  using C = Cfg<CO>;
  if (cin % C::CK) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t px = static_cast<cuuint64_t>(stride) * 4;  // bytes per pixel
  const cuuint64_t in_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                                 static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t in_strides[3] = {px, px * W, px * W * H};
  const cuuint32_t in_box[4] = {4, HALO_W, C::HALO_H, 1};
  CUtensorMap in_map, w_map;
  if (encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(buf), in_dims,
             in_strides, in_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(cin), 9};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cout) * 4,
                                   static_cast<cuuint64_t>(cout) * 4 * cin};
  const cuuint32_t w_box[3] = {CO, C::CK, 9};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), w_dims, w_strides,
             w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const auto kernel = conv3x3_f32_kernel<CO>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::THREADS, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + C::TH - 1) / C::TH;
  const long long tiles = static_cast<long long>(B) * tiles_y * tiles_x * (cout / CO);
  if (tiles < 1 || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms * per_sm ? tiles : sms * per_sm);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(in_map, w_map, static_cast<const float*>(buf), H,
                                                W, stride, cin, bias, cout, dst, dst_stride,
                                                residual, tiles_x, tiles_y,
                                                static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// buf: the f32 concat buffer, stride floats between pixels, read over
// channels [0, cin); w: HWIO (3, 3, cin, cout); bias: (cout,); dst: the
// level's first output channel, dst_stride floats between pixels;
// residual != 0 for level 5. Needs cout % 32 == 0, cin a multiple of the
// chunk (8 channels at cout % 128 != 0, 16 at cout % 128 == 0), and what
// TMA and the 16-byte stores need: 16-byte-aligned buf, w and dst, strides
// that are multiples of 4 floats (the Python wrappers check these and
// raise; here they return cudaErrorInvalidValue /
// cudaErrorMisalignedAddress). Launches on `stream` and returns the
// cudaError_t of the launch.
inline int launch(const void* buf, int B, int H, int W, int stride, int cin, const void* w,
                  const void* bias, int cout, void* dst, int dst_stride, int residual,
                  cudaStream_t stream) {
  if (cout % 32 || cin > stride || cout > dst_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(buf) || misaligned(w) || misaligned(dst) || stride % 4 || dst_stride % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* bf = static_cast<const float*>(bias);
  auto* out = static_cast<float*>(dst);
  if (cout % 128 == 0)
    return launch_co<128>(buf, B, H, W, stride, cin, w, bf, cout, out, dst_stride, residual,
                          stream);
  return launch_co<32>(buf, B, H, W, stride, cin, w, bf, cout, out, dst_stride, residual, stream);
}

}  // namespace conv3x3_f32
