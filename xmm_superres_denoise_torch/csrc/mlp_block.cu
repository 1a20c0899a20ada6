// The MLP half of the transformer zoo's blocks, fused, for Hopper (sm_90a),
// with a plain C interface for ctypes:
//   out = x + fc2(GELU(fc1(LayerNorm(x))))
// over T tokens of C channels, the hidden width H = 4C at the cells.
//
// Replaces no Pallas kernel: the JAX package writes this line as jnp ops in
// models/swin_common.py (`Mlp`, the blocks' `x + mlp(norm2(x))`) and
// hat.py (HAB, OCAB), which XLA fuses on the TPU. The port's plain
// version, ops/mlp_block.py: mlp_block_plain, runs it as PyTorch ops: the
// f32 cast, LayerNorm and the cast back, the fc1 GEMM writing the hidden
// (T x H bf16), its bias add, GELU, the fc2 GEMM, its bias add and the
// residual add, each a pass over device memory.
//
// What it computes, with the plain version's roundings, each in registers:
// LayerNorm's statistics and affine step in f32 on the bf16 parameters
// (gamma * (rstd * (x - mean)) + beta), rounded to bf16 once; fc1's
// product (bf16 operands, f32 sums on the tensor cores) rounded to bf16,
// plus b1 rounded to bf16 (a bf16x2 add, the exact sum rounded once, as
// the plain version's f32 add of two bf16 values and its cast give), the
// exact GELU x * 0.5 * (1 + erf(x / sqrt 2)) in f32 rounded to bf16;
// fc2's product rounded to bf16, plus b2 rounded, plus x rounded. What may
// differ is the order of the f32 sums (LayerNorm's, and both products'),
// so a rounding near a bf16 boundary may land one ulp away.
//
// Range (checked by the wrapper): C even, C <= 192 (fc1's K and fc2's N are
// padded with zeros to KP = 192); H <= 768, padded with zero rows of W1,
// zero b1 and zero columns of W2 to a whole number of 48-wide chunks (a
// padded hidden unit's W2 column is 0). SwinIR, SwinFIR and HAT run C =
// 180, H = 720 (15 chunks), as does each DRCT group's first block; DRCT's
// wider blocks stay on the plain version.
//
// What bounds it on this card. At batch 4 of the cells' 416^2 tokens (T =
// 692,224) a call reads x and writes out, 0.498 GB: 0.149 ms at 3.35 TB/s;
// its products, 359 GFLOP, are 0.363 ms at 989 TFLOP/s (0.387 with C padded
// to 192). Two more limits come close. (1) The bias, GELU and roundings of
// the T x H hidden, 0.5 G elements: erff alone is about 20 instructions, so
// GELU goes through a table (below); what is left is about 12 instructions
// and one shared-memory load an element, whose random addresses conflict in
// the banks. (2) L2: the padded weights, 553 KB, are read for every tile; at
// 128 tokens a tile that is 3.0 GB a call. A 2-CTA cluster multicasting the
// weights would halve (2); a tile of 256 tokens would need 192 accumulator
// registers a thread for fc2 alone. chip_smoke.py prints the kernel's time
// beside its bound; PERF.md says what was measured to bound it.
//
// Design. A persistent grid, one CTA of three warpgroups an SM (dynamic
// shared memory 222,416 B), walks the 128-token tiles blockIdx.x, +
// gridDim.x, ...
// * Producer: one thread of warpgroup 2 (setmaxnreg 40) starts every copy.
//   The weights stream chunk by chunk, tile after tile, through a ring of 3
//   stages by 1-D bulk copies on mbarriers; the wrapper lays each chunk out
//   as its shared-memory image (W1's rows and W2's columns of 48 hidden
//   units, 36,864 B, with the 32-byte swizzle: 48 units are 96 bytes, which
//   the wider swizzles do not divide), so one copy brings a chunk. Each
//   consumer's 64 rows of x come into its X buffer by a bulk copy too (rows
//   of C channels are 360 bytes, not a legal 2-D tensor-map stride) as soon
//   as LayerNorm has read the previous tile's, so they arrive while that
//   tile is worked on; L2 is asked for them a tile earlier still
//   (cp.async.bulk.prefetch.L2).
// * Consumers: warpgroups 0 and 1 (setmaxnreg 232) take rows 0-63 and
//   64-127 of each tile. LayerNorm: the quad of lanes 4g..4g+3 reads rows rt
//   and rt + 8 from X (copying them to the warpgroup's O buffer for the
//   residual), reduces with two shuffles and writes the normalised rows
//   straight into fc1's A fragments (48 registers; zeros past C). Then per
//   chunk c of 48 hidden units:
//   1. fc1: wgmma m64n48k16, A from registers, B from the stage, f32;
//   2. + b1, GELU and the roundings in registers: GELU of a bf16 value is
//      read from a table of every bf16 value with |x| in [2^-16, 8), 9,728
//      B, which each CTA computes with the same erff formula when it starts
//      (so it is bitwise the formula's); a value outside the table (zero,
//      tiny or large) is computed, in a branch its warp takes together. The
//      bf16 results are packed into A fragments in place (the accumulator
//      layout of 16 columns is the A layout of one k16 step);
//   3. fc2: wgmma m64n192k16 with A from registers, accumulating the 64 x
//      192 f32 output (96 registers a thread) over every chunk; fc2(c) and
//      fc1(c + 1) are one group on the tensor cores.
// * Epilogue: fc2's sums rounded, + b2, + x from O, written over x in O,
//   and one thread stores the rows with a bulk copy.
// The hidden never leaves the SM: device memory sees x read once and out
// written once. The last tile's bytes past a multiple of 16 are copied by
// one thread each way.

#include <cstdint>
#include <type_traits>
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
using wgmma::fence_proxy_async;
using wgmma::keep;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int KP = 192;              // C padded: fc1's K, fc2's N
constexpr int HC = 48;               // hidden units a chunk
constexpr int KSTEPS = KP / 16;      // k16 steps of fc1
constexpr int HSTEPS = HC / 16;      // k16 steps of fc2 a chunk
constexpr int PAIRS = KP / 8;        // channel pairs of a row a thread holds: 8j + 2t
constexpr int MAX_CHUNKS = 16;       // H <= 768
constexpr int ROWS = 64;             // a consumer warpgroup's rows
constexpr int TILE = 2 * ROWS;       // tokens a tile
constexpr int STAGES = 3;
constexpr int W1_REGION = HC * 32;   // one k16 step of the chunk's W1 rows
constexpr int W2_REGION = KP * 32;   // one k16 step of the chunk's W2 columns
constexpr int W1_BYTES = KSTEPS * W1_REGION;
constexpr int STAGE_BYTES = W1_BYTES + HSTEPS * W2_REGION;  // 36,864
// GELU of every bf16 value with |x| in [2^-16, 8) (exponent fields 111 to
// 129), both signs: 19 binades of 128
constexpr uint32_t GELU_E0 = 111;
constexpr uint32_t GELU_SIDE = 19 * 128;
// the vectors (bf16): gamma, beta, b2 (KP each, zeros past C), b1 (chunks x HC)
constexpr int V_GAMMA = 0, V_BETA = KP, V_B2 = 2 * KP, V_B1 = 3 * KP;
constexpr int VEC_ELEMS = 3 * KP + MAX_CHUNKS * HC;
constexpr int X_BYTES = ROWS * KP * 2;  // a consumer's rows, C <= KP wide
constexpr int X_OFF = STAGES * STAGE_BYTES;  // x as it arrives
constexpr int O_OFF = X_OFF + 2 * X_BYTES;   // x for the residual, then out
constexpr int TABLE_OFF = O_OFF + 2 * X_BYTES;
constexpr int VEC_OFF = TABLE_OFF + 2 * GELU_SIDE * 2;
constexpr int BAR_OFF = VEC_OFF + VEC_ELEMS * 2;
constexpr int SMEM_BYTES = 1024 + BAR_OFF + (2 * STAGES + 4) * 8;
constexpr int THREADS = 3 * 128;  // two consumer warpgroups and the producer's

static_assert(STAGE_BYTES % 1024 == 0 && BAR_OFF % 8 == 0, "aligned regions");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

struct Params {
  const __nv_bfloat16* x;    // (T, C)
  __nv_bfloat16* out;        // (T, C)
  const uint8_t* w;          // chunks x STAGE_BYTES: each chunk's shared-memory image
  const __nv_bfloat16* vec;  // V_* above
  long long tokens;
  int C, chunks, tiles;
  float eps;
};

// Descriptor of a K-major operand of one k16 step with the 32-byte swizzle:
// rows of 32 bytes, 8-row atoms 256 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// d (64 x 48 f32, this thread's 24) (+)= a (64 x 16 bf16 in registers) * B (16 x 48
// through desc_b, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 192 f32, this thread's 96) (+)= a (64 x 16 bf16 in registers) * B (16 x 192
// through desc_b, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[96], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
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

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// Bytes [src, src + bytes) of shared memory to global memory, as one bulk
// group of this thread.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

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
// version's f32 add of two bf16 values and its cast to bf16 give.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// PyTorch's exact GELU in its f32 op math: x * 0.5 * (1 + erf(x * M_SQRT1_2)).
__device__ __forceinline__ float gelu_erf(float x) {
  constexpr float kAlpha = 0.70710678118654752440f;
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// The index of a bf16 value b (its 16 bits) in the GELU table, clamped
// into it; `out` is set where b lies outside the table's range.
__device__ __forceinline__ uint32_t gelu_index(uint32_t b, bool& out) {
  const uint32_t k = (b & 0x7FFFu) - (GELU_E0 << 7);
  out |= k >= GELU_SIDE;
  return min(k, GELU_SIDE - 1) + (b >> 15) * GELU_SIDE;
}

__global__ void __launch_bounds__(THREADS, 1) mlp_block_sm90_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + BAR_OFF;
  uint16_t* const table = reinterpret_cast<uint16_t*>(smem + TABLE_OFF);
  uint32_t* const vec = reinterpret_cast<uint32_t*>(smem + VEC_OFF);  // pairs of bf16
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  // x_full[w]: consumer w's rows of x are in its X buffer; x_empty[w]: the
  // buffer's output rows have been stored, and it takes the next tile's
  const auto x_full = [&](int w) { return bars + 8 * (2 * STAGES + w); };
  const auto x_empty = [&](int w) { return bars + 8 * (2 * STAGES + 2 + w); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(x_full(w), 1);
      mbar_init(x_empty(w), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the GELU table: entry k + s * GELU_SIDE is the bf16 value of sign s and
  // bits (GELU_E0 << 7) + k (exponent field GELU_E0 + k / 128)
  for (int i = threadIdx.x; i < 2 * GELU_SIDE; i += THREADS) {
    const uint32_t k = i % GELU_SIDE, s = i / GELU_SIDE;
    const float x = __uint_as_float(((GELU_E0 << 7) + k | s << 15) << 16);
    table[i] = static_cast<uint16_t>(pack_bf16(gelu_erf(x), 0.f) & 0xFFFFu);
  }
  const int vec_elems = 3 * KP + p.chunks * HC;
  for (int i = threadIdx.x; i < vec_elems / 2; i += THREADS) vec[i] = ld32(p.vec + 2 * i);
  __syncthreads();

  const long long T = p.tokens;
  const int C = p.C, n = p.chunks;
  // rows of consumer w's half of `tile`, 0 to 64; bulk copies move their
  // bytes down to a multiple of 16, and one thread the rest (the last tile's)
  const auto half_rows = [&](int tile, int w) {
    const long long r = T - (static_cast<long long>(tile) * TILE + w * ROWS);
    return static_cast<int>(r < 0 ? 0 : r < ROWS ? r : ROWS);
  };

  if (threadIdx.x >= 2 * 128) {  // the producer's warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      int it = 0;  // chunks loaded, across tiles
      int k = 0;   // tiles begun
      // each consumer's rows of x into its X buffer
      const auto load_x = [&](int tile) {
        for (int w = 0; w < 2; ++w) {
          if (k > 0) mbar_wait(x_empty(w), (k - 1) & 1);
          const uint32_t bytes = static_cast<uint32_t>(half_rows(tile, w) * C * 2) & ~15u;
          if (bytes) {
            mbar_expect_tx(x_full(w), bytes);
            bulk_load(base + X_OFF + w * X_BYTES, p.x + (static_cast<long long>(tile) * TILE + w * ROWS) * C,
                      bytes, x_full(w));
          } else {
            mbar_arrive(x_full(w));
          }
        }
      };
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
        const long long next = static_cast<long long>(tile + gridDim.x) * TILE;
        if (next < T) {
          const long long rows = T - next < TILE ? T - next : TILE;
          const uint32_t bytes = static_cast<uint32_t>(rows * C * 2) & ~15u;
          if (bytes) prefetch_l2(p.x + next * C, bytes);
        }
        // the tile's rows of x, once LayerNorm has read the previous tile's
        load_x(tile);
        for (int c = 0; c < n; ++c, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          bulk_load(base + s * STAGE_BYTES, p.w + static_cast<long long>(c) * STAGE_BYTES,
                    STAGE_BYTES, full(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128, wt = threadIdx.x & 127;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rt = 16 * warp + g;  // this thread's rows of the warpgroup's 64: rt, rt + 8
    const float inv_c = 1.0f / static_cast<float>(C);
    uint8_t* const xb = smem + X_OFF + wg * X_BYTES;  // the warpgroup's rows of x as they arrive
    uint8_t* const ob = smem + O_OFF + wg * X_BYTES;  // the same rows for the residual, then out
    const uint32_t ob_u32 = base + O_OFF + wg * X_BYTES;
    // pair (row r, channels ch, ch + 1) of a buffer (rows of C, dense)
    const auto pair = [&](uint8_t* buf, int r, int ch) {
      return reinterpret_cast<uint32_t*>(buf + (r * C + ch) * 2);
    };

    float acc2[96];             // fc2's sums: 64 x 192
    float acc1[24];             // fc1's sums of one chunk: 64 x 48
    uint32_t xa[KSTEPS][4];     // the normalised rows as fc1's A fragments
    uint32_t fr[HSTEPS][4];     // a chunk's GELU output as fc2's A fragments

    int it = 0;  // chunks consumed, across tiles
    int k = 0;   // tiles begun
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, it += n, ++k) {
      const int rows = half_rows(tile, wg);
      const int nbytes = rows * C * 2, bulk = nbytes & ~15;
      const long long row0 = static_cast<long long>(tile) * TILE + wg * ROWS;
      mbar_wait(x_full(wg), k & 1);
      // O is free once the previous tile's bulk store has read it
      if (wt == 0) {
        bulk_wait_read();
        for (int b = bulk; b < nbytes; b += 2)  // the last tile's tail, under 16 bytes
          *reinterpret_cast<uint16_t*>(xb + b) =
              __ldg(reinterpret_cast<const unsigned short*>(p.x + row0 * C) + b / 2);
      }
      sync_warpgroup(wg);

      // LayerNorm of rows rt and rt + 8: the quad of lanes 4g..4g+3 holds all
      // their channels (8j + 2t, + 1); statistics and the affine step in f32
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rt + 8 * h;
        uint32_t xr[PAIRS];
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const int ch = 8 * j + 2 * t;
          xr[j] = r < rows && ch < C ? *pair(xb, r, ch) : 0u;
          if (r < rows && ch < C) *pair(ob, r, ch) = xr[j];
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) sum += lo_f(xr[j]) + hi_f(xr[j]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float mean = sum * inv_c;
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const float d0 = lo_f(xr[j]) - mean, d1 = hi_f(xr[j]) - mean;
          if (8 * j + 2 * t < C) sq = fmaf(d1, d1, fmaf(d0, d0, sq));
        }
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        const float rstd = rsqrtf(sq * inv_c + p.eps);
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const int ch = 8 * j + 2 * t;
          const uint32_t gm = vec[(V_GAMMA + ch) / 2], bt = vec[(V_BETA + ch) / 2];
          const uint32_t v = pack_bf16(fmaf(lo_f(gm), rstd * (lo_f(xr[j]) - mean), lo_f(bt)),
                                       fmaf(hi_f(gm), rstd * (hi_f(xr[j]) - mean), hi_f(bt)));
          xa[j >> 1][2 * (j & 1) + h] = ch < C ? v : 0u;
        }
      }

      // X is read: the producer may bring the next tile's rows
      sync_warpgroup(wg);
      if (wt == 0) mbar_arrive(x_empty(wg));

      // the sums start here: no value of the previous tile's lives on
#pragma unroll
      for (int i = 0; i < 96; ++i) acc2[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 24; ++i) acc1[i] = 0.f;

      const auto stage = [&](int c) { return base + ((it + c) % STAGES) * STAGE_BYTES; };
      const auto wait_full = [&](int c) {
        mbar_wait(full((it + c) % STAGES), ((it + c) / STAGES) & 1);
      };
      const auto release = [&](int c) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((it + c) % STAGES));
      };
      // fc1 of chunk c: acc1 (64 x 48) = normalised rows x W1 chunk^T
      const auto fc1 = [&](int c) {
        const uint32_t sb = stage(c);
#pragma unroll
        for (int kb = 0; kb < KSTEPS; ++kb)
          wgmma_m64n48k16_rs(acc1, xa[kb], desc_sw32(sb + kb * W1_REGION), kb > 0);
      };
      // fc2 of chunk c: acc2 (64 x 192) += GELU output (64 x 48) x W2 chunk^T
      const auto fc2 = [&](int c, const uint32_t (&f)[HSTEPS][4]) {
        const uint32_t sb = stage(c) + W1_BYTES;
#pragma unroll
        for (int kk = 0; kk < HSTEPS; ++kk)
          wgmma_m64n192k16_rs(acc2, f[kk], desc_sw32(sb + kk * W2_REGION), c > 0 || kk > 0);
      };
      // bias, GELU and roundings of chunk c's fc1 sums into f: acc1[4j +
      // 2 half + e] is row rt + 8 half, hidden unit 48c + 8j + 2t + e, and k16
      // step kk of fc2 takes j = 2kk (a0 row rt, a1 row rt + 8) and j = 2kk + 1
      // (a2, a3)
      const auto gelu_chunk = [&](int c, uint32_t (&f)[HSTEPS][4]) {
        const uint32_t* b1 = vec + (V_B1 + c * HC) / 2 + t;
        const auto biased = [&](int j, int half) {
          return add_bf16x2(pack_bf16(acc1[4 * j + 2 * half], acc1[4 * j + 2 * half + 1]), b1[4 * j]);
        };
        bool out = false;
#pragma unroll
        for (int j = 0; j < HC / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t h = biased(j, half);
            f[j >> 1][2 * (j & 1) + half] =
                table[gelu_index(h & 0xFFFFu, out)] | table[gelu_index(h >> 16, out)] << 16;
          }
        // values outside the table (rare): computed, in a branch the warp
        // takes together
        if (__any_sync(0xffffffffu, out)) {
#pragma unroll
          for (int j = 0; j < HC / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const uint32_t h = biased(j, half);
              bool o = false;
              gelu_index(h & 0xFFFFu, o);
              gelu_index(h >> 16, o);
              if (o) f[j >> 1][2 * (j & 1) + half] = pack_bf16(gelu_erf(lo_f(h)), gelu_erf(hi_f(h)));
            }
        }
      };
      const auto keep_fr = [&](uint32_t (&f)[HSTEPS][4]) {
#pragma unroll
        for (int kk = 0; kk < HSTEPS; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) keep(f[kk][x]);
      };
      const auto keep_xa = [&] {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) keep(xa[kk][x]);
      };

      wait_full(0);
      wgmma_fence();
      fc1(0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 24; ++i) keep(acc1[i]);
      gelu_chunk(0, fr);
      // chunk j < n - 1: fc2(j) and fc1(j + 1) on the tensor cores, then
      // GELU(j + 1)
      for (int j = 0; j + 1 < n; ++j) {
        wait_full(j + 1);
        wgmma_fence();
        fc2(j, fr);
        fc1(j + 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 24; ++i) keep(acc1[i]);
        keep_fr(fr);
        release(j);
        gelu_chunk(j + 1, fr);
      }
      keep_xa();
      wgmma_fence();
      fc2(n - 1, fr);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 96; ++i) keep(acc2[i]);
      keep_fr(fr);
      release(n - 1);

      // fc2's sums rounded, + b2, + x: acc2[4j + 2 h + e] is row rt + 8 h,
      // channel 8j + 2t + e; the output replaces x in the X buffer, which one
      // thread then stores with a bulk copy
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rt + 8 * h;
#pragma unroll
        for (int j = 0; j < PAIRS; ++j) {
          const int ch = 8 * j + 2 * t;
          if (r < rows && ch < C) {
            const uint32_t y = add_bf16x2(pack_bf16(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]),
                                          vec[(V_B2 + ch) / 2]);
            *pair(ob, r, ch) = add_bf16x2(*pair(ob, r, ch), y);
          }
        }
      }
      fence_proxy_async();
      sync_warpgroup(wg);
      if (wt == 0) {
        __nv_bfloat16* dst = p.out + row0 * C;
        if (bulk) bulk_store(dst, ob_u32, bulk);
        for (int b = bulk; b < nbytes; b += 2)
          reinterpret_cast<uint16_t*>(dst)[b / 2] = *reinterpret_cast<const uint16_t*>(ob + b);
      }
    }
    if (wt == 0) bulk_wait();
  }
}

}  // namespace

extern "C" {

// x and out (T, C) bf16, contiguous, 16-byte aligned; w the chunks' images
// (chunks x 36,864 B, 16-byte aligned) and vec the vectors, both laid out by
// the Python wrapper (ops/mlp_block.py: weights_of). Returns the cudaError_t
// of the launch (0 = cudaSuccess).
int mlp_block(int device, const void* x, void* out, const void* w, const void* vec,
              long long tokens, int channels, int chunks, float eps, void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (channels < 2 || channels > KP || channels % 2 || chunks < 1 || chunks > MAX_CHUNKS ||
      tokens < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (tokens + TILE - 1) / TILE;
  if (tiles == 0) return 0;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // per device: set on each launch, which costs the host little
  err = cudaFuncSetAttribute(mlp_block_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.w = static_cast<const uint8_t*>(w);
  p.vec = static_cast<const __nv_bfloat16*>(vec);
  p.tokens = tokens;
  p.C = channels, p.chunks = chunks, p.tiles = static_cast<int>(tiles);
  p.eps = eps;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  mlp_block_sm90_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mlp_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
