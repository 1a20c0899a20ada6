// The qkv side of the transformer zoo's Swin blocks, fused, for Hopper
// (sm_90a), with a plain C interface for ctypes:
//   out = window_partition(roll(LayerNorm(x), -shift)) @ W_qkv^T + b_qkv
// over B images of H x W tokens of C channels, written as the (B * nW * N,
// 3C) rows that the blocks' qkv projection writes, N = ws * ws tokens a
// window.
//
// Replaces no Pallas kernel: the JAX package writes this as jnp ops in
// models/swin_common.py (the Swin block's norm1, roll, window_partition and
// the qkv Dense) and hat.py (HAB's), which XLA fuses on the TPU. The port's
// plain version, ops/window_qkv.py: window_qkv_plain, runs it as PyTorch
// ops: the f32 cast, LayerNorm and the cast back, torch.roll in shifted
// blocks, the partition's permute copy, the qkv GEMM and its bias add, each
// a pass over device memory (about 40 bytes a token and channel, against
// the 8 that x in and q, k, v out need).
//
// What it computes, with the plain version's roundings, each in registers:
// output row r is token (r % N) of window r / N, whose source pixel is
// ((y + shift) mod H, (x + shift) mod W), so the shift and the partition
// are index arithmetic; LayerNorm's statistics and affine step in f32 on the
// bf16 parameters (gamma * (rstd * (x - mean)) + beta), rounded to bf16
// once (the template parameter NORM; HAT's HAB hands over its normalised
// image and runs without it); the product (bf16 operands, f32 sums on the
// tensor cores) rounded to bf16, plus the bias rounded to bf16 (a bf16x2
// add: the exact sum rounded once, as the plain version's add of two bf16
// values gives). What may differ is the order of the f32 sums (LayerNorm's
// and the product's), so a rounding near a bf16 boundary may land one ulp
// away.
//
// Range (checked by the wrapper): C even, C <= 320, the product's K padded
// with zeros to KS steps of 16, the template parameter: the least of 12,
// 14, 16, 18 and 20 that holds C (exact at the cells' widths, 180 to 308;
// a narrower C runs the KS = 12 instance on zeros); 3C padded with zero rows of W to whole 64-column chunks; H and W
// multiples of ws, 0 <= shift < ws. SwinIR and SwinFIR run C = 180 at
// window 13 unshifted, HAT's HABs C = 180 at window 16 shifted by 8 in odd
// blocks (without the norm), DRCT's dense blocks C = 180, 212, 244, 276 and
// 308 at window 16, shifted in blocks 2 and 4.
//
// What bounds it on this card. At batch 4 of the cells' 416^2 tokens (T =
// 692,224) a call reads x (2C bytes a token) and writes q, k, v (6C): at C
// = 180 1.00 GB, 0.30 ms at 3.35 TB/s, at C = 308 1.71 GB, 0.51 ms. Its
// products, with K and 3C padded, are 153 and 425 GFLOP: 0.15 and 0.43 ms
// at 989 TFLOP/s. So bytes bound it, with the products close behind at the
// widest C. Two more limits come close. (1) The rows: a token row is 2C
// bytes, 8 mod 16 at every width the cells run, so neither a bulk copy nor
// a tensor map reads a row in place; nor is a (T, 3C) output row a legal
// tensor-map stride. (2) L2: the weights are read for every tile of 128
// rows, 221 KB at C = 180 and 614 KB at C = 308: 1.2 and 3.3 GB a call.
//
// Design. A persistent grid, one CTA of three warpgroups an SM, walks the
// 128-row tiles blockIdx.x, + gridDim.x, ...
// * Producers' warpgroup (setmaxnreg 48: the gather's index arithmetic
//   spilled a register at 40; 48 x 128 + 224 x 256 is the 168 x 384 the
//   launch holds). One thread streams the weights, chunk by chunk, tile
//   after tile, through a ring of 3 to 8 stages (as many as shared memory
//   holds) by 1-D bulk copies on mbarriers; the
//   wrapper lays each chunk of 64 output columns out as its shared-memory
//   image (KS regions of 64 rows x 16 channels with the 32-byte swizzle),
//   so one copy brings a chunk. The other three warps gather each
//   consumer's 64 rows into its X buffer as soon as that consumer has read
//   the previous tile's: a lane computes the source token of one row (the
//   divisions once a row), the warp's lanes then copy each row with 8-byte
//   cp.async (4-byte at C = 2 mod 4), and each lane's copies arrive on the
//   buffer's mbarrier when they land (cp.async.mbarrier.arrive.noinc), so
//   the gather overlaps the previous tile's products.
// * Consumers: warpgroups 0 and 1 (setmaxnreg 224) take rows 0-63 and
//   64-127 of each tile. LayerNorm: the quad of lanes 4g..4g+3 reads rows
//   rt and rt + 8 from X straight into the A fragments of the product (4
//   KS registers; zeros past C), reduces both rows' sums with two shuffles
//   each and normalises them in place, each gamma and beta pair read once
//   for the two rows. Then per chunk c of 64 output columns: wgmma
//   m64n64k16 over the KS steps, A from registers, B from the stage, into
//   32 accumulator registers; once they land, the epilogue rounds the sums,
//   adds the bias from shared memory and stores, while the other
//   warpgroup's products run on the tensor cores: a shuffle between lanes
//   2i and 2i + 1 gives each four adjacent columns, one 8-byte store (at C
//   = 0 mod 4; else a pair of columns, 4 bytes), a quad writing 32 bytes of
//   a row. (Two accumulators, chunk c + 1's products issued before chunk
//   c's epilogue, measured no faster on an H100: ptxas serialises wgmma
//   when the epilogue reads one accumulator while the other is in flight.)
// Neither the normalised rows nor the windows leave the SM: device memory
// sees x read once and q, k, v written once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;
using wgmma::keep;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int ROWS = 64;            // a consumer warpgroup's rows
constexpr int TILE = 2 * ROWS;      // rows a tile
constexpr int NC = 64;              // output columns a chunk
constexpr int MAX_STAGES = 8;
constexpr int REGION = NC * 32;     // one k16 step of a chunk: 64 rows of 16 bf16
constexpr int MAX_C = 320;
constexpr int MAX_CHUNKS = (3 * MAX_C + NC - 1) / NC;  // 15
constexpr int THREADS = 3 * 128;    // two consumer warpgroups and the producers' warpgroup
constexpr int GATHER_WARPS = 3;     // warps 1-3 of the producers' warpgroup

// Shared memory of the instance with KS k16 steps (C <= 16 KS): the X
// buffers, the vectors and the barriers, and as many weight stages as the
// rest holds (7 at KS = 12, 3 at KS = 20), up to MAX_STAGES.
template <int KS>
struct Layout {
  static constexpr int STAGE_BYTES = KS * REGION;
  static constexpr int X_BYTES = ROWS * KS * 16 * 2;  // a consumer's rows, dense, 2C bytes each
  // the vectors (bf16): gamma, beta (16 KS each, zeros past C), bias (chunks x NC)
  static constexpr int VEC_ELEMS = 2 * 16 * KS + MAX_CHUNKS * NC;
  static constexpr int FIXED = 1024 + 2 * X_BYTES + VEC_ELEMS * 2 + (2 * MAX_STAGES + 4) * 8;
  static constexpr int STAGES =
      (232448 - FIXED) / STAGE_BYTES < MAX_STAGES ? (232448 - FIXED) / STAGE_BYTES : MAX_STAGES;
  static constexpr int X_OFF = STAGES * STAGE_BYTES;
  static constexpr int VEC_OFF = X_OFF + 2 * X_BYTES;
  static constexpr int BAR_OFF = VEC_OFF + VEC_ELEMS * 2;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + (2 * STAGES + 4) * 8;
  static_assert(STAGES >= 2 && STAGE_BYTES % 1024 == 0 && BAR_OFF % 8 == 0, "aligned regions");
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

struct Params {
  const __nv_bfloat16* x;    // (B, H * W, C)
  __nv_bfloat16* out;        // (B * nW * N, 3C)
  const uint8_t* w;          // chunks x KS * REGION: each chunk's shared-memory image
  const __nv_bfloat16* vec;  // gamma, beta (16 KS each), bias (chunks x NC)
  int rows;                  // T = B * H * W
  int C, ks, chunks, tiles;  // ks: the instance's KS
  int H, W, ws, shift;
  int wide;                  // C % 4 == 0: 8-byte copies and stores
  int has_bias;
  float eps;
};

// Descriptor of a K-major operand of one k16 step with the 32-byte swizzle:
// rows of 32 bytes, 8-row atoms 256 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// d (64 x 64 f32, this thread's 32) (+)= a (64 x 16 bf16 in registers) * B (16 x 64
// through desc_b, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// One arrival on `bar` once every cp.async this thread has started has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The 128 threads of consumer warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void sync_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two bf16 sums, each the exact sum rounded to bf16: what the plain
// version's add of two bf16 values gives.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The token of x that output row r reads: row r % N of window r / N, the
// window's pixel moved by the cyclic shift.
__device__ __forceinline__ int source_token(const Params& p, int r) {
  const int n = p.ws * p.ws, nwx = p.W / p.ws, nw = (p.H / p.ws) * nwx;
  const int win = r / n, pos = r - win * n;
  const int b = win / nw, wl = win - b * nw;
  const int wy = wl / nwx, wx = wl - wy * nwx;
  const int py = pos / p.ws, px = pos - py * p.ws;
  int y = wy * p.ws + py + p.shift, xx = wx * p.ws + px + p.shift;
  if (y >= p.H) y -= p.H;
  if (xx >= p.W) xx -= p.W;
  return (b * p.H + y) * p.W + xx;
}

template <int KS, bool NORM>
__global__ void __launch_bounds__(THREADS, 1) window_qkv_sm90_kernel(const Params p) {
  using L = Layout<KS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t* const vec = reinterpret_cast<const uint32_t*>(smem + L::VEC_OFF);  // bf16 pairs
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (L::STAGES + s); };
  // x_full[w]: consumer w's rows are in its X buffer; x_empty[w]: the
  // consumer has read them, and the buffer takes the next tile's
  const auto x_full = [&](int w) { return bars + 8 * (2 * L::STAGES + w); };
  const auto x_empty = [&](int w) { return bars + 8 * (2 * L::STAGES + 2 + w); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(x_full(w), GATHER_WARPS * 32);  // one arrival per gathering thread
      mbar_init(x_empty(w), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int C = p.C, kp = 16 * KS, n = p.chunks;
  const int v_beta = kp, v_bias = 2 * kp;
  {
    uint32_t* const v = reinterpret_cast<uint32_t*>(smem + L::VEC_OFF);
    for (int i = threadIdx.x; i < kp + n * NC / 2; i += THREADS) v[i] = ld32(p.vec + 2 * i);
  }
  __syncthreads();

  const int stage_bytes = L::STAGE_BYTES;
  const int row_bytes = 2 * C;
  // rows of consumer w's half of `tile`, 0 to 64
  const auto half_rows = [&](int tile, int w) {
    const int r = p.rows - (tile * TILE + w * ROWS);
    return r < 0 ? 0 : r < ROWS ? r : ROWS;
  };
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 2 * 128) {  // the producers' warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 48;\n" ::: "memory");
    const int pw = (threadIdx.x >> 5) - 8;  // 0: the weights' warp, then the gathering warps
    if (pw == 0) {
      if (lane == 0) {  // the weights, chunk after chunk, through the ring
        int it = 0;
        for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
          for (int c = 0; c < n; ++c, ++it) {
            const int s = it % L::STAGES;
            if (it >= L::STAGES) mbar_wait(empty(s), ((it / L::STAGES) - 1) & 1);
            mbar_expect_tx(full(s), stage_bytes);
            bulk_load(base + s * L::STAGE_BYTES, p.w + static_cast<long long>(c) * stage_bytes,
                      stage_bytes, full(s));
          }
        }
      }
    } else {  // the rows: this warp takes rows gw, gw + GATHER_WARPS, ... of each half
      const int gw = pw - 1;
      const int words = p.wide ? C / 4 : C / 2;  // 8- or 4-byte copies a row
      const char* const xb = reinterpret_cast<const char*>(p.x);
      int k = 0;  // tiles begun
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
        for (int w = 0; w < 2; ++w) {
          if (k > 0) mbar_wait(x_empty(w), (k - 1) & 1);
          const int rows = half_rows(tile, w), row0 = tile * TILE + w * ROWS;
          // lane l finds the source of the warp's row j = l (22 rows at most)
          const int mine = gw + GATHER_WARPS * lane;
          const int src = mine < rows ? source_token(p, row0 + mine) : 0;
          const uint32_t dst0 = base + L::X_OFF + w * L::X_BYTES;
          for (int j = 0; gw + GATHER_WARPS * j < rows; ++j) {
            const int i = gw + GATHER_WARPS * j;
            const char* const s = xb + static_cast<long long>(__shfl_sync(0xffffffffu, src, j)) * row_bytes;
            const uint32_t d = dst0 + i * row_bytes;
            if (p.wide) {
              for (int e = lane; e < words; e += 32) cp_async8(d + 8 * e, s + 8 * e);
            } else {
              for (int e = lane; e < words; e += 32) cp_async4(d + 4 * e, s + 4 * e);
            }
          }
          cp_async_arrive(x_full(w));
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = threadIdx.x / 128, wt = threadIdx.x & 127;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int rt = 16 * warp + g;  // this thread's rows of the warpgroup's 64: rt, rt + 8
    const float inv_c = 1.0f / static_cast<float>(C);
    const int n3 = 3 * C;
    const uint8_t* const xs = smem + L::X_OFF + wg * L::X_BYTES;  // the warpgroup's rows
    // pair (row r, channels ch, ch + 1) of the X buffer (rows of C, dense)
    const auto pair = [&](int r, int ch) {
      return *reinterpret_cast<const uint32_t*>(xs + r * row_bytes + ch * 2);
    };

    float acc[32];              // a chunk's sums: 64 x 64
    uint32_t xa[KS][4];         // the normalised rows as the product's A fragments

    int it = 0;  // chunks consumed, across tiles
    int k = 0;   // tiles begun
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, it += n, ++k) {
      const int rows = half_rows(tile, wg);
      const long long row0 = static_cast<long long>(tile) * TILE + wg * ROWS;
      mbar_wait(x_full(wg), k & 1);

      // rows rt and rt + 8: the quad of lanes 4g..4g+3 holds all their
      // channels (8j + 2t, + 1), read into the A fragments and normalised
      // there; LayerNorm's statistics and affine step in f32
      const auto frag = [&](int j, int h) -> uint32_t& { return xa[j >> 1][2 * (j & 1) + h]; };
#pragma unroll
      for (int j = 0; j < 2 * KS; ++j) {
        const int ch = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) frag(j, h) = rt + 8 * h < rows && ch < C ? pair(rt + 8 * h, ch) : 0u;
      }
      if constexpr (NORM) {
        float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f}, mean[2], rstd[2];
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) sum[h] += lo_f(frag(j, h)) + hi_f(frag(j, h));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          mean[h] = sum[h] * inv_c;
        }
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d0 = lo_f(frag(j, h)) - mean[h], d1 = hi_f(frag(j, h)) - mean[h];
            if (8 * j + 2 * t < C) sq[h] = fmaf(d1, d1, fmaf(d0, d0, sq[h]));
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
          rstd[h] = rsqrtf(sq[h] * inv_c + p.eps);
        }
#pragma unroll
        for (int j = 0; j < 2 * KS; ++j) {
          const int ch = 8 * j + 2 * t;
          const uint32_t gm = vec[ch / 2], bt = vec[(v_beta + ch) / 2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t x = frag(j, h);
            const uint32_t v = pack_bf16(fmaf(lo_f(gm), rstd[h] * (lo_f(x) - mean[h]), lo_f(bt)),
                                         fmaf(hi_f(gm), rstd[h] * (hi_f(x) - mean[h]), hi_f(bt)));
            frag(j, h) = ch < C ? v : 0u;
          }
        }
      }

      // X is read: the gathering warps may bring the next tile's rows
      sync_warpgroup(wg);
      if (wt == 0) mbar_arrive(x_empty(wg));

      // the sums start here: no value of the previous tile's lives on
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;

      // chunk c's products into d: wgmma over the KS steps, B from its stage
      const auto issue = [&](int c, float (&d)[32]) {
        const int s = (it + c) % L::STAGES;
        mbar_wait(full(s), ((it + c) / L::STAGES) & 1);
        const uint32_t sb = base + s * L::STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < KS; ++kb)
          wgmma_m64n64k16_rs(d, xa[kb], desc_sw32(sb + kb * REGION), kb > 0);
        wgmma_commit();
      };
      // chunk c's sums (products done): the stage goes back to the ring;
      // each sum rounded, + bias rounded, stored. d[4j + 2h + e] is row
      // rt + 8h, column 64c + 8j + 2t + e.
      const auto epilogue = [&](int c, float (&d)[32]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) keep(d[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((it + c) % L::STAGES));
        const int n0 = c * NC;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rt + 8 * h;
          __nv_bfloat16* const orow = p.out + (row0 + r) * n3;
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // columns 16i .. 16i + 15 of the chunk
            const int ca = n0 + 16 * i + 2 * t, cb = ca + 8;
            uint32_t ya = pack_bf16(d[8 * i + 2 * h], d[8 * i + 2 * h + 1]);
            uint32_t yb = pack_bf16(d[8 * i + 4 + 2 * h], d[8 * i + 4 + 2 * h + 1]);
            if (p.has_bias) {
              ya = add_bf16x2(ya, vec[(v_bias + ca) / 2]);
              yb = add_bf16x2(yb, vec[(v_bias + cb) / 2]);
            }
            if (p.wide) {
              // lanes 2i and 2i + 1 of the quad swap halves: the even one
              // keeps columns ca .. ca + 3, the odd one cb - 2 .. cb + 1
              const bool odd = t & 1;
              const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? ya : yb, 1);
              const int col = odd ? cb - 2 : ca;
              if (r < rows && col < n3)
                *reinterpret_cast<uint2*>(orow + col) = odd ? make_uint2(got, yb) : make_uint2(ya, got);
            } else if (r < rows) {
              if (ca < n3) *reinterpret_cast<uint32_t*>(orow + ca) = ya;
              if (cb < n3) *reinterpret_cast<uint32_t*>(orow + cb) = yb;
            }
          }
        }
      };

      // each chunk's products, then its epilogue; the other warpgroup's
      // products run on the tensor cores meanwhile
      for (int c = 0; c < n; ++c) {
        issue(c, acc);
        wgmma_wait<0>();
        epilogue(c, acc);
      }
#pragma unroll
      for (int kb = 0; kb < KS; ++kb)
#pragma unroll
        for (int x = 0; x < 4; ++x) keep(xa[kb][x]);
    }
  }
}

template <int KS, bool NORM>
cudaError_t launch_instance(const Params& p, int sms, cudaStream_t stream) {
  constexpr int smem = Layout<KS>::SMEM_BYTES;
  // per device: set on each launch, which costs the host little
  cudaError_t err = cudaFuncSetAttribute(window_qkv_sm90_kernel<KS, NORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  window_qkv_sm90_kernel<KS, NORM><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool NORM>
cudaError_t launch(const Params& p, int sms, cudaStream_t stream) {
  switch (p.ks) {
    case 12: return launch_instance<12, NORM>(p, sms, stream);
    case 14: return launch_instance<14, NORM>(p, sms, stream);
    case 16: return launch_instance<16, NORM>(p, sms, stream);
    case 18: return launch_instance<18, NORM>(p, sms, stream);
    case 20: return launch_instance<20, NORM>(p, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (B, H * W, C) bf16 and out (B * nW * N, 3C) bf16, contiguous, 8-byte
// aligned (4 at C = 2 mod 4); w the chunks' images (chunks x k_steps *
// 2,048 B, 16-byte aligned; k_steps 12, 14, 16, 18 or 20, at least C /
// 16) and vec the vectors, both laid out by the Python wrapper
// (ops/window_qkv.py: weights_of); norm 0 skips LayerNorm, has_bias 0 the
// bias. Returns the cudaError_t of the launch (0 = cudaSuccess).
int window_qkv(int device, const void* x, void* out, const void* w, const void* vec,
               long long rows, int channels, int k_steps, int chunks, int height, int width,
               int window, int shift, int norm, int has_bias, float eps, void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (channels < 2 || channels > MAX_C || channels % 2 || 16 * k_steps < channels ||
      chunks != (3 * channels + NC - 1) / NC ||
      window < 1 || window * window > 256 || height < window || width < window ||
      height % window || width % window || shift < 0 || shift >= window || rows < 0 ||
      rows % (static_cast<long long>(height) * width) || rows > 0x7FFFFFFFll - TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.w = static_cast<const uint8_t*>(w);
  p.vec = static_cast<const __nv_bfloat16*>(vec);
  p.rows = static_cast<int>(rows);
  p.C = channels, p.ks = k_steps, p.chunks = chunks;
  p.tiles = static_cast<int>((rows + TILE - 1) / TILE);
  p.H = height, p.W = width, p.ws = window, p.shift = shift;
  p.wide = channels % 4 == 0;
  p.has_bias = has_bias;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(norm ? launch<true>(p, sms, s) : launch<false>(p, sms, s));
}

const char* window_qkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
