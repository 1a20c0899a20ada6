// The Gram side of Restormer's MDTA (channel attention), for Hopper (sm_90a),
// with a plain C interface for ctypes:
//   attn = softmax(temperature * (q_hat . k_hat^T))  per (image, head), (d x d)
// where q and k are the first two thirds of the depthwise convolution's
// output qkv (NHWC, bf16), q_hat and k_hat their rows (channels) L2-normalised
// over the pixels, and the product contracts over every pixel of the image.
//
// Replaces no Pallas kernel: the JAX package writes these lines as jnp ops
// (models/restormer.py:95-101: the two norms, the einsum with f32 results,
// the temperature and the softmax), which XLA fuses on the TPU. The port's
// plain version, ops/mdta_gram.py: mdta_attention_plain, runs them as
// PyTorch ops: per operand a square, a sum over the strided pixel axis, a
// root, a clamp and a divide in bf16, then both upcast to f32 and an f32
// GEMM whose (d x d) output is a few tiles, so a handful of SMs carry all of
// the 173,056 pixels of a 416^2 image.
//
// What it computes: the same function with two bf16 roundings fewer. A
// bf16 x bf16 product is exact in f32, so wgmma's f32 sums of bf16 q and k
// are the products the f32 GEMM sums, in another order; the normalisation
// moves onto the (d x d) result with the norms in f32:
//   G_ij / (max(|q_i|, 1e-12) * max(|k_j|, 1e-12)) * float(bf16(temperature)),
// the softmax over j in f32, rounded to bf16 once.
//
// What bounds it on this card. At the cell's batch of 4 images of 416^2, a
// call reads q and k once: 4 x 173,056 x 2 x 48 channels x 2 bytes = 133 MB
// at level 1 (d 48), 0.0397 ms at 3.35 TB/s; 0.0793 ms at d 96 (the decoder's
// first level and the refinement), 0.0198, 0.0099 and 0.0050 ms at levels 2,
// 3 and the latent: 1.19 ms a forward of 44 calls. Its products are 24 to
// 48 operations a byte, far below the 295 at which the tensor cores would
// bound it. So the design reads each byte once and keeps enough of them in
// flight on every SM:
// * mdta_gram_sm90_kernel splits the pixels: one CTA for each (image, head,
//   chunk of pixels), the chunk count chosen from the shape by the wrapper
//   (ops/mdta_gram.py: plan) so that the largest calls put at least two CTAs
//   on each SM, and the partials stay under a tenth of the bytes read. A
//   producer warp streams the chunk's q and k rows through a ring of 3
//   stages by TMA, straight from qkv's NHWC rows (row stride 3c; q of head h
//   at channel h d, k at c + h d): each stage holds R pixels of q and of k,
//   each operand as d / W boxes of W channels with the matching swizzle,
//   which is wgmma's MN-major layout. A consumer warpgroup runs wgmma
//   m64nNk16 with both operands from shared memory, transposed: A = q^T
//   (M = the d rows, padded to 64, or two halves of 64 past 64), B = k
//   (N = d rounded up to 48, 64, 96 or 128); W (64, 32, 16 or 8) is the
//   widest that divides d and N, so B spans whole boxes; the padded rows
//   and columns read whatever follows in shared memory and are discarded.
//   From the same tiles its threads take the f32 sums of squares of q and
//   k, while the tensor cores work. Each CTA writes its (d x d) f32 partial
//   and its 2d partial sums of squares to a workspace.
// * mdta_softmax_sm90_kernel finishes one row of one (image, head) a CTA:
//   sums the partials in chunk order (no atomics: repeated calls are bitwise
//   equal), applies the norms and the temperature, and takes the softmax.
// Reducing across blocks takes the second kernel; neither gains alone.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using tma::EncodeTiled;
using tma::encode_tiled;
using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;
using tma::tma_load_3d;
using wgmma::keep;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int STAGES = 3;
constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and the producer's warp
constexpr int MAX_D = 128;
constexpr int NORM_BYTES = CONSUMERS * 8 * 4;  // the sums of squares of each thread
constexpr int SOFTMAX_THREADS = MAX_D;      // one a column
constexpr int MAX_SMEM = 232448;            // an SM's opt-in shared memory

struct Params {
  float* ws;           // (grid, d * d + 2 d): each CTA's Gram, then its q and k sums of squares
  int c, heads, d;     // q's channels (c = heads * d)
  int pixels;          // h * w of an image
  int rows;            // R: pixels a stage
  int width;           // W: channels a box (an MN atom of the layout)
  int chunk_px;        // pixels a chunk, a multiple of R
  int chunks;          // chunks an (image, head)
  uint32_t atom_bytes;   // R * 2W: one box
  uint32_t stage_bytes;  // 2 d / W boxes
  uint32_t norm_off, bar_off;
};

// Descriptor of an MN-major operand: start address, leading and stride byte
// offsets, layout (0: none, 1: 128-byte, 2: 64-byte, 3: 32-byte swizzle).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(layout) << 62);
}

// d (64 x N f32, this thread's N / 2) += A (64 x 16) * B (16 x N), both
// from shared memory through MN-major descriptors (the transposed forms).
__device__ __forceinline__ void wgmma_m64n48k16_ss(float (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n96k16_ss(float (&d)[48], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 48) wgmma_m64n48k16_ss(d, a, b);
  else if constexpr (N == 64) wgmma_m64n64k16_ss(d, a, b);
  else if constexpr (N == 96) wgmma_m64n96k16_ss(d, a, b);
  else wgmma_m64n128k16_ss(d, a, b);
}

// One CTA: the (d x d) Gram q^T k and the sums of squares of q's and k's
// channels over one chunk of one image's pixels, for one head. N: B's width
// (d rounded up); MH: 64-row halves of A (d > 64 takes two).
template <int N, int MH>
__global__ void __launch_bounds__(THREADS, MH == 1 ? 3 : 2)
    mdta_gram_sm90_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + p.bar_off;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int d = p.d, W = p.width, R = p.rows;
  const int boxes = d / W;  // boxes of one operand a stage
  const int bh = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const int img = bh / p.heads, head = bh % p.heads;
  const int px0 = chunk * p.chunk_px;
  const int px1 = min(px0 + p.chunk_px, p.pixels);
  const int steps = (px1 - px0 + R - 1) / R;  // stages of the chunk; TMA fills rows past the image with zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer: one thread starts every copy
    if (threadIdx.x == CONSUMERS) {
      const int q0 = head * d, k0 = p.c + head * d;
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), p.stage_bytes);
        const uint32_t dst = base + s * p.stage_bytes;
        const int row = px0 + it * R;
        for (int a = 0; a < boxes; ++a) {
          tma_load_3d(dst + a * p.atom_bytes, &map, full(s), q0 + a * W, row, img);
          tma_load_3d(dst + (boxes + a) * p.atom_bytes, &map, full(s), k0 + a * W, row, img);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  // the layout: a stage is q's boxes then k's, each R rows of 2W bytes; row
  // groups of 8 are 16W bytes apart, boxes atom_bytes apart
  const uint32_t row_bytes = 2 * W;
  const uint32_t layout = W == 64 ? 1u : W == 32 ? 2u : W == 16 ? 3u : 0u;
  const uint32_t lbo = layout ? p.atom_bytes : 16 * W;  // no swizzle: LBO along K, SBO along MN
  const uint32_t sbo = layout ? 16 * W : p.atom_bytes;
  const uint32_t half_bytes = (64 / W) * p.atom_bytes;  // A's second 64 rows
  const uint32_t k_bytes = boxes * p.atom_bytes;        // k's first box

  // the sums of squares: thread t takes 16 bytes (8 channels) of column
  // `col` of q's and k's 2d / 8, in rows phase, phase + phases, ...
  const int cols = d / 4, per_box = W / 8;
  const int col = t % cols, phase = t / cols, phases = CONSUMERS / cols;
  const bool summing = phase < phases;
  const int side = col / (d / 8), cc = col % (d / 8);
  const uint32_t col_off = (side * boxes + cc / per_box) * p.atom_bytes;
  const uint32_t u = cc % per_box;
  float sq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sq[e] = 0.f;

  float acc[MH][N / 2];
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t sb = base + s * p.stage_bytes;
    wgmma_fence();
    for (int k = 0; k < R / 16; ++k) {
      const uint32_t kb = k * 16 * row_bytes;
      const uint64_t db = desc_mn(sb + k_bytes + kb, lbo, sbo, layout);
#pragma unroll
      for (int m = 0; m < MH; ++m)
        mma<N>(acc[m], desc_mn(sb + m * half_bytes + kb, lbo, sbo, layout), db);
    }
    wgmma_commit();
    if (summing) {
      const uint8_t* const tile = smem + s * p.stage_bytes + col_off;
      for (int r = phase; r < R; r += phases) {
        const uint32_t off = r * row_bytes;
        const uint4 v = *reinterpret_cast<const uint4*>(
            tile + off + ((u ^ ((off >> 7) & (per_box - 1))) << 4));
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = __uint_as_float(w4[e] << 16), hi = __uint_as_float(w4[e] & 0xFFFF0000u);
          sq[2 * e] = fmaf(lo, lo, sq[2 * e]);
          sq[2 * e + 1] = fmaf(hi, hi, sq[2 * e + 1]);
        }
      }
    }
    __syncwarp();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MH; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) keep(acc[m][i]);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // the partials: acc[m][4j + 2 hf + e] is row 64 m + 16 warp + g + 8 hf,
  // column 8j + 2 tq + e of the Gram
  float* const out = p.ws + static_cast<long long>(blockIdx.x) * (d * d + 2 * d);
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 64 * m + 16 * warp + g + 8 * hf, cl = 8 * j + 2 * tq;
        if (row < d && cl < d)  // d % 8 == 0: both columns or neither
          *reinterpret_cast<float2*>(out + row * d + cl) =
              make_float2(acc[m][4 * j + 2 * hf], acc[m][4 * j + 2 * hf + 1]);
      }
  // the sums of squares, over the phases in order: channel 8 col + e of q's
  // and k's 2d
  float* const red = reinterpret_cast<float*>(smem + p.norm_off);
  if (summing)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(phase * cols + col) * 8 + e] = sq[e];
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  for (int ch = t; ch < 2 * d; ch += CONSUMERS) {
    float total = 0.f;
    for (int ph = 0; ph < phases; ++ph) total += red[(ph * cols + ch / 8) * 8 + ch % 8];
    out[d * d + ch] = total;
  }
}

// One CTA a row i of one (image, head): the partials summed in chunk order,
// the norms and the temperature applied, the softmax over the row's d
// columns, one a thread.
__global__ void __launch_bounds__(SOFTMAX_THREADS)
    mdta_softmax_sm90_kernel(const float* __restrict__ ws, const __nv_bfloat16* __restrict__ temperature,
                             __nv_bfloat16* __restrict__ out, int heads, int d, int chunks) {
  __shared__ float red[SOFTMAX_THREADS / 32];
  const int i = blockIdx.x, bh = blockIdx.y, j = threadIdx.x;
  const int warp = j >> 5, lane = j & 31;
  const long long part = static_cast<long long>(d) * d + 2 * d;
  const float* const w = ws + static_cast<long long>(bh) * chunks * part;
  const bool on = j < d;
  const int jc = on ? j : 0;
  float gram = 0.f, qq = 0.f, kk = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < chunks; ++ch) {
    const float* const pc = w + ch * part;
    gram += pc[i * d + jc];
    qq += pc[d * d + i];
    kk += pc[d * d + d + jc];
  }
  const float temp = __bfloat162float(temperature[bh % heads]);
  const float qn = fmaxf(sqrtf(qq), 1e-12f), kn = fmaxf(sqrtf(kk), 1e-12f);
  const float logit = on ? gram / (qn * kn) * temp : -__int_as_float(0x7f800000);  // -inf

  float m = logit;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int k = 1; k < SOFTMAX_THREADS / 32; ++k) m = fmaxf(m, red[k]);
  __syncthreads();
  const float e = on ? expf(logit - m) : 0.f;
  float s = e;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = red[0];
#pragma unroll
  for (int k = 1; k < SOFTMAX_THREADS / 32; ++k) s += red[k];
  if (on) out[(static_cast<long long>(bh) * d + i) * d + j] = __float2bfloat16_rn(e / s);
}

template <int N, int MH>
int gram(int device, const CUtensorMap& map, const Params& p, int smem, int grid,
         cudaStream_t stream) {
  auto kernel = mdta_gram_sm90_kernel<N, MH>;
  // the limit belongs to each device's copy of the kernel: set it to the
  // most any call takes, once a device (a bit each for devices 0-63, on
  // every launch past them), since the small calls' time is the host's
  static std::atomic<uint64_t> ready{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready.fetch_or(bit, std::memory_order_release);
  }
  kernel<<<grid, THREADS, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv (batch, pixels, 3c) bf16 with channels contiguous, pixel_stride and
// batch_stride elements between pixels and images (multiples of 8) and a
// 16-byte aligned start; temperature (heads) bf16; out (batch, heads, d, d)
// bf16; ws (batch * heads * chunks, d * d + 2 d) f32. d = c / heads a
// multiple of 8 up to 128; `rows` (a multiple of 16, at most 256), `width`
// (8, 16, 32 or 64, dividing d and N) and the chunking are the wrapper's
// (ops/mdta_gram.py: plan). Launches both kernels on `stream` and returns
// the cudaError_t of the launches (0 = cudaSuccess).
int mdta_gram(int device, const void* qkv, const void* temperature, void* out, float* ws,
              int batch, int pixels, int c, int heads, int rows, int width, int chunk_px,
              int chunks, long long pixel_stride, long long batch_stride, void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch < 1 || pixels < 1 || heads < 1 || c % heads) return static_cast<int>(cudaErrorInvalidValue);
  const int d = c / heads;
  if (d % 8 || d < 8 || d > MAX_D || (width != 8 && width != 16 && width != 32 && width != 64) ||
      d % width || rows % 16 || rows < 16 || rows > 256 || chunk_px < rows || chunk_px % rows ||
      chunks < 1 || static_cast<long long>(chunks) * chunk_px < pixels ||
      static_cast<long long>(chunks - 1) * chunk_px >= pixels ||
      static_cast<long long>(batch) * heads * chunks > 0x7FFFFFFF || pixel_stride < 3LL * c)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || pixel_stride % 8 || batch_stride % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(3 * c), static_cast<cuuint64_t>(pixels),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pixel_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : width == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                   : CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const int n = d <= 48 ? 48 : d <= 64 ? 64 : d <= 96 ? 96 : 128;
  const int mh = d > 64 ? 2 : 1;
  if (n % width) return static_cast<int>(cudaErrorInvalidValue);
  const int boxes = d / width;
  Params p;
  p.ws = ws;
  p.c = c, p.heads = heads, p.d = d, p.pixels = pixels, p.rows = rows, p.width = width;
  p.chunk_px = chunk_px, p.chunks = chunks;
  p.atom_bytes = static_cast<uint32_t>(rows * 2 * width);
  p.stage_bytes = 2 * boxes * p.atom_bytes;
  // the last stage's padded rows of A and columns of B read past the ring
  int pad = mh * 64 / width - 2 * boxes;
  if (n / width - boxes > pad) pad = n / width - boxes;
  p.norm_off = STAGES * p.stage_bytes + (pad > 0 ? pad : 0) * p.atom_bytes;
  p.bar_off = p.norm_off + NORM_BYTES;
  const int smem = 1024 + static_cast<int>(p.bar_off) + 2 * STAGES * 8;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = batch * heads * chunks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = n == 48   ? gram<48, 1>(device, map, p, smem, grid, st)
            : n == 64 ? gram<64, 1>(device, map, p, smem, grid, st)
            : n == 96 ? gram<96, 2>(device, map, p, smem, grid, st)
                      : gram<128, 2>(device, map, p, smem, grid, st);
  if (err != 0) return err;
  mdta_softmax_sm90_kernel<<<dim3(d, batch * heads), SOFTMAX_THREADS, 0, st>>>(
      ws, static_cast<const __nv_bfloat16*>(temperature), static_cast<__nv_bfloat16*>(out), heads,
      d, chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* mdta_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
