// Window attention of the transformer zoo, fused, for Hopper (sm_90a), with
// a plain C interface for ctypes:
//   out = softmax(bf16(q * scale) @ k^T + bias [+ mask]) @ v
// for a batch of (window, head) pairs, the logits and the probabilities
// kept in registers.
//
// Replaces no Pallas kernel: the JAX package writes this as jnp ops in
// models/swin_common.py (and hat.py's OCAB), which XLA fuses on the TPU.
// The port's plain version, ops/window_attention.py:
// window_attention_plain, runs it as PyTorch ops: an f32 logits GEMM on the
// CUDA cores, then the bias add, the mask add, the softmax and the bf16
// cast each as a pass over the f32 logits in device memory, then attn @ v.
//
// What it computes, per pair (b, h) with b the window, h the head: q (N, d),
// k and v (M, d) bf16, read by their strides (window, head, row; the d
// channels contiguous), so qkv's (B_, N, 3, nh, d) view and OCAB's unfolded
// keys and values are read in place. q * scale is rounded to bf16 with the
// scale itself a bf16 value (the wrapper rounds it), as the plain version's
// bf16 multiply does. The logits are products of bf16 values, exact in
// f32, summed in f32 by the tensor cores (the plain version's f32 GEMM on
// upcast operands, in another order). The bias, (nh, N, ldb) in bf16 as
// the models gather it from their bf16 tables (exact in f32), is added in
// f32, then mask[b % nW] (nW, N, M) f32. The softmax runs in f32: each
// row's max, the sum of exp(s - max), and p = exp(s - max) / sum rounded to
// bf16 once it is normalised, as the plain version rounds it. p @ v sums in
// f32 and rounds once to bf16. The output is (B_, N, nh * d) bf16, the
// layout the caller's transpose and reshape want, so that copy goes.
// Range (checked by the wrapper): N <= 256; d <= 128, padded with zeros to
// DK = 32, 64 or 128 (the template parameter; an odd d to 64 or more); M <=
// 576, 384 or 256 for those DK. SwinIR, SwinFIR and HAT have d = 30, DRCT's
// dense blocks 30, 53, 122, 46 and 77 (M = 256 at each at window 16). An odd
// d is read and written 16 bits at a time, an even one a pair of channels at
// a time.
//
// What bounds it on this card. Per SwinIR image (36 blocks of 1,024 13 x 13
// windows x 6 heads) q, k, v and the output are 9.0 GB: 2.7 ms at 3.35
// TB/s; HAT (36 HABs at 256 x 256, 6 OCABs at 256 x 576) 11.4 GB, 3.4 ms.
// The two products, d padded to 32, are 0.96 and 1.68 TFLOP: 1.0 and 1.7
// ms at 989 TFLOP/s. The exponentials, 6.3 G and 13.2 G, are 1.5 and 3.2
// ms on the SFUs (16 a cycle an SM). The bias and mask are read from L2
// once per logit (12.6 GB a SwinIR image, 45 GB a HAT image). So no
// single unit bounds it: bytes, exponentials and L2 reads are each a few
// milliseconds an image, and the kernel keeps every one of them to one
// pass, where the plain version makes five passes over f32 logits in
// device memory (52.8 ms of bytes a SwinIR image, 121.4 a HAT one).
//
// Design. A block is one (window, head) pair: KS consumer warpgroups (128
// threads each), KS = ceil(chunks / C) with chunks = ceil(M / 64) and C = 3,
// 2, 1 at DK = 32, 64, 128, each owning CPW = ceil(chunks / KS) chunks of 64
// keys (a template parameter; at DK = 32 SwinIR 1 x 3, HAB 2 x 2, OCAB 3 x
// 3). At DK = 128 three warpgroups of one chunk reach 192 keys; past that
// (DRCT's d = 122 and 77 at window 16: 256 keys) two warpgroups hold two
// chunks each, 256 threads with up to 255 registers, where a fourth
// warpgroup of one chunk would cap every thread at 128 registers beside the
// 64 of its O. Below 193 keys the three-warpgroup form stays: at DRCT's
// window 13 (169 keys, 4,096 windows) it takes 1.70 ms at d 122 and 8.30 at
// d 77 against the two-chunk form's 2.27 and 10.20 on an H100 SXM. The
// block stages k (rows of DK bf16 in blocks of 32 channels,
// zero past d and past M) and v transposed (DK channel rows per 32 keys) in
// shared memory with the 64-byte swizzle, all of a thread's loads issued
// before its stores (in two halves in the two-chunk DK = 128 form), then
// walks the ceil(N / 64) query tiles of 64 rows.
// Per tile each warpgroup:
// 1. loads its q fragments straight from device memory into registers,
//    scaled and rounded (the A operand of the RS form), at DK = 32 the next
//    tile's while this one's are worked on;
// 2. wgmma m64n64k16 per chunk and k16 step: S (64 x 64 f32 a chunk, 32
//    registers a thread) = q k^T, B through a descriptor of the k rows;
//    without a mask the tile's bias loads while these run;
// 3. adds bias and mask to its S registers, -inf past M, and takes each
//    row's max (a quad's shuffles, then shared memory across warpgroups);
// 4. exponentiates, sums the same way, scales by 1 / sum and packs the
//    bf16 probabilities into A fragments in place (the accumulator layout of
//    a 64-key chunk is the A layout of its four k16 steps);
// 5. wgmma m64n{DK}k16: O (64 x DK f32, DK / 2 registers) += P v, B through a
//    descriptor of v's transposed rows; the warpgroups' partial O meet in
//    shared memory, and the first stores the tile's rows < N, channels < d.
// No logit leaves the SM. Rows past N and keys past M are computed as zeros
// and -inf and never stored.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "wgmma.cuh"

namespace {

using wgmma::fence_proxy_async;
using wgmma::keep;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int ROWS = 64;    // query rows per tile: one warpgroup's m64
constexpr int CHUNK = 64;   // keys per S chunk: n64
constexpr int ROW = 64;     // bytes of one staged row (32 bf16): one 64-byte swizzle row

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long q_sb, q_sh, q_sn;  // strides in elements: window, head, row
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  const __nv_bfloat16* bias;  // (nh, N, ldb) or null
  const float* mask;  // (nW, ...) with strides m_sw, m_sn, or null
  long long m_sw;
  int m_sn, mask_pairs;  // mask_pairs: (col, col + 1) loads as one float2
  __nv_bfloat16* out;    // (B_, N, nh * d)
  int nh, N, M, d, ldb, nW;
  int pairs;  // q, k, v: a pair of channels to one 32-bit load
  float scale;  // a bf16 value
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte `byte` of row `row` of a region with the 64-byte swizzle (rows of 64
// bytes, 8-row atoms of 512 bytes): the 16-byte piece index XORs with bits
// 7-8 of the offset, (row >> 1) & 3.
__device__ __forceinline__ uint32_t sw64(int row, int byte) {
  return row * ROW + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

// Descriptor of a K-major B slice with the 64-byte swizzle: rows of 64
// bytes, 8-row atoms 512 bytes apart (SBO). A k16 step advances the start
// address by 32 bytes, the descriptor by 2.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// d (64 x 64 f32, this thread's 32) += a (64 x 16 bf16 in registers) * B (16 x 64).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 32 f32, this thread's 16) += a (64 x 16 bf16 in registers) * B (16 x 32).
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

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (MUFU.EX2, flush to zero): exp(s - max) as 2^(s log2 e -
// max log2 e), one FFMA before it; -inf gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two channels of one q row, times the scale, each rounded to bf16.
__device__ __forceinline__ uint32_t scaled_pair(uint32_t w, float scale) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xFFFF0000u);
  return pack_bf16(lo * scale, hi * scale);
}

// One pair of channels (ch, ch + 1) of a row, ch < d: one 32-bit load when
// the operands allow it (`pairs`: d even, strides even, starts aligned),
// else two 16-bit loads, the second zero at ch + 1 == d.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int ch, int d, bool pairs) {
  if (pairs) return ld32(p);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = ch + 1 < d ? *reinterpret_cast<const uint16_t*>(p + 1) : 0u;
  return lo | hi << 16;
}

// P v into O (64 x DK f32, this thread's DK / 2): wgmma m64n{DK}k16.
template <int DK>
__device__ __forceinline__ void pv_mma(float (&o)[DK / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (DK == 32) wgmma_m64n32k16(o, a, desc);
  else if constexpr (DK == 64) wgmma_m64n64k16(o, a, desc);
  else wgmma::wgmma_m64n128k16(o, a, desc);
}

// The split the wrapper makes (ops/window_attention.py: _split): at most
// max_cpw(DK) chunks of 64 keys a warpgroup, at most 3 warpgroups, so the S
// registers (32 a chunk) fit beside O (DK / 2) and the q fragments (DK / 4);
// at DK = 128 two chunks a warpgroup only with two warpgroups (256 keys).
// The widest block of each instance, and the blocks an SM should hold: at
// DK = 32, CPW 1 and 2 are held to 128 registers, so two HAB blocks share
// an SM.
__host__ __device__ constexpr int max_cpw(int dk) { return dk == 32 ? 3 : 2; }
__host__ __device__ constexpr int max_ks(int dk, int cpw) {
  return dk == 32 ? cpw : dk == 64 ? (cpw == 2 ? 3 : 1) : (cpw == 1 ? 3 : 2);
}
// The two-chunk form at DK = 128 runs only as two warpgroups: no fewer.
__host__ __device__ constexpr int min_ks(int dk, int cpw) { return dk == 128 && cpw == 2 ? 2 : 1; }
__host__ __device__ constexpr int min_blocks(int dk, int cpw) {
  return dk == 32 ? (cpw == 1 ? 4 : cpw == 2 ? 2 : 1) : 1;
}

// Shared memory of a block with KS warpgroups of CPW chunks each, past the
// slack that aligns it to 1024 bytes: k (DK / 32 blocks of 64-byte rows, one
// per key), v^T (a block of DK 64-byte rows per 32 keys), the row maxima
// and sums of each warpgroup, the partial O of warpgroups 1..KS-1.
__host__ __device__ constexpr int smem_bytes(int ks, int cpw, int dk) {
  return 1024 + 2 * ks * cpw * CHUNK * dk * 2 + 2 * ks * ROWS * 4 + (ks - 1) * (dk / 2) * 128 * 4;
}

template <int DK, int CPW, bool MASK>
__global__ void __launch_bounds__(128 * max_ks(DK, CPW), min_blocks(DK, CPW))
    window_attention_sm90_kernel(const Params p) {
  constexpr int KK = DK / 16;  // k16 steps of q k^T
  constexpr int CP = DK / 2;   // channel pairs of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  // A form that takes more than one warpgroup at least takes exactly that
  // many (min_ks == max_ks), so its block size is a constant here and the
  // staging addresses fold to offsets of one base.
  constexpr int FIXED_KS = min_ks(DK, CPW) > 1 ? min_ks(DK, CPW) : 0;
  const int KS = FIXED_KS ? FIXED_KS : blockDim.x / 128;
  const int threads = FIXED_KS ? 128 * FIXED_KS : blockDim.x;
  const int Mp = KS * CPW * CHUNK;
  uint8_t* const s_k = smem;
  uint8_t* const s_v = smem + Mp * DK * 2;
  float* const red_max = reinterpret_cast<float*>(s_v + Mp * DK * 2);
  float* const red_sum = red_max + KS * ROWS;
  float* const o_part = red_sum + KS * ROWS;
  const uint32_t s_k_u32 = smem_u32(s_k), s_v_u32 = smem_u32(s_v);

  const int h = blockIdx.x % p.nh, b = blockIdx.x / p.nh;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int N = p.N, M = p.M, d = p.d;
  const bool pairs = DK == 32 || p.pairs;  // an odd d pads to 64 or more

  // Each thread stages CPW * DK / 4 pairs of k and CPW * DK / 8 pairs of
  // pairs of v (Mp * DK / 2 and Mp * DK / 4 items over 128 * KS threads),
  // all loads of a pass issued before its first store: one pass, or two
  // halves in the two-chunk DK = 128 form, whose 128 words at once would
  // not fit beside their addresses.
  constexpr int PASSES = FIXED_KS ? 2 : 1;
  constexpr int KW = CPW * DK / 4 / PASSES, VW = CPW * DK / 8 / PASSES;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    // k: item (key, channel pair); zeros past M and past d
    uint32_t kw[KW];
#pragma unroll
    for (int it = 0; it < KW; ++it) {
      const int i = tid + (pass * KW + it) * threads, key = i / CP, ch = 2 * (i % CP);
      kw[it] = key < M && ch < d ? ld_pair(kb + key * p.k_sn + ch, ch, d, pairs) : 0u;
    }
    // v transposed: item (key pair, channel pair) -> two words of two keys,
    // one in channel row ch, one in ch + 1, of the key's 32-key block
    uint32_t vw[VW][2];
#pragma unroll
    for (int it = 0; it < VW; ++it) {
      const int i = tid + (pass * VW + it) * threads, key = 2 * (i / CP), ch = 2 * (i % CP);
      vw[it][0] = key < M && ch < d ? ld_pair(vb + key * p.v_sn + ch, ch, d, pairs) : 0u;
      vw[it][1] =
          key + 1 < M && ch < d ? ld_pair(vb + (key + 1) * p.v_sn + ch, ch, d, pairs) : 0u;
    }
#pragma unroll
    for (int it = 0; it < KW; ++it) {
      const int i = tid + (pass * KW + it) * threads, key = i / CP, ch = 2 * (i % CP);
      *reinterpret_cast<uint32_t*>(s_k + (ch >> 5) * Mp * ROW + sw64(key, 2 * (ch & 31))) = kw[it];
    }
#pragma unroll
    for (int it = 0; it < VW; ++it) {
      const int i = tid + (pass * VW + it) * threads, key = 2 * (i / CP), ch = 2 * (i % CP);
      uint8_t* blk = s_v + (key >> 5) * DK * ROW;
      const int byte = 2 * (key & 31);
      *reinterpret_cast<uint32_t*>(blk + sw64(ch, byte)) = __byte_perm(vw[it][0], vw[it][1], 0x5410);
      *reinterpret_cast<uint32_t*>(blk + sw64(ch + 1, byte)) =
          __byte_perm(vw[it][0], vw[it][1], 0x7632);
    }
  }
  fence_proxy_async();
  __syncthreads();

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* bias = p.bias ? p.bias + (long long)h * N * p.ldb : nullptr;
  const float* mask = MASK ? p.mask + (b % p.nW) * p.m_sw : nullptr;
  const int key0 = wg * CPW * CHUNK;  // this warpgroup's first key
  const int rows = (N + ROWS - 1) / ROWS;

  // 1. q fragments of the k16 steps: a0 row r0 channels 16kk + 2t, a1 row
  // r1, a2 row r0 channels 16kk + 8 + 2t, a3 row r1. At DK = 32 the next
  // tile's load while this one's logits are worked on (wider heads have no
  // registers to spare for it).
  const int rt = 16 * warp + g;  // this thread's rows in a tile: rt, rt + 8
  uint32_t qraw[KK][4];
  const auto load_q = [&](int tile) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = tile * ROWS + rt + 8 * (x & 1), ch = 16 * kk + 8 * (x >> 1) + 2 * t;
        qraw[kk][x] = row < N && ch < d ? ld_pair(qb + row * p.q_sn + ch, ch, d, pairs) : 0u;
      }
  };
  constexpr bool PREFETCH_Q = DK == 32;
  if (PREFETCH_Q) load_q(0);

  for (int tile = 0; tile < rows; ++tile) {
    const int r[2] = {tile * ROWS + rt, tile * ROWS + rt + 8};
    if (!PREFETCH_Q) load_q(tile);
    uint32_t qa[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) qa[kk][x] = scaled_pair(qraw[kk][x], p.scale);

    // 2. S = q k^T, a chunk of 64 keys at a time; k16 step kk reads k's
    // channel block kk / 2
    float s[CPW][32];
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[c][i] = 0.f;
        keep(s[c][i]);
      }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint32_t kc = s_k_u32 + (kk >> 1) * Mp * ROW + (key0 + c * CHUNK) * ROW;
        wgmma_m64n64k16(s[c], qa[kk], desc_sw64(kc) + 2 * (kk & 1));
      }
    wgmma_commit();
    if (PREFETCH_Q && tile + 1 < rows) load_q(tile + 1);
    // The tile's bias pairs (bf16): without a mask all of them load while
    // the products run; with one, a half chunk's at a time beside its mask
    // pairs (all at once, the masked forms spill).
    uint32_t bw[CPW][8][2];
    const auto load_bias = [&](int c, int j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r[half], col = key0 + c * CHUNK + 8 * j + 2 * t;
        bw[c][j][half] = row < N && col < M && bias
                             ? __ldg(reinterpret_cast<const unsigned int*>(bias + row * p.ldb + col))
                             : 0u;
      }
    };
    if (!MASK) {
#pragma unroll
      for (int c = 0; c < CPW; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) load_bias(c, j);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) keep(s[c][i]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) keep(qa[kk][x]);

    // 3. bias, mask, -inf past M; row maxima. s[c][4j + 2 half + e] is row
    // r[half], key key0 + 64c + 8j + 2t + e.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        float2 mv[4][2];  // mask pairs
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (MASK) load_bias(c, j0 + j);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r[half], col = key0 + c * CHUNK + 8 * (j0 + j) + 2 * t;
            const bool in = row < N && col < M;
            mv[j][half] = make_float2(0.f, 0.f);
            if (MASK && in) {
              const float* mr = mask + row * p.m_sn + col;
              if (p.mask_pairs) {
                mv[j][half] = __ldg(reinterpret_cast<const float2*>(mr));
              } else {
                mv[j][half].x = __ldg(mr);
                if (col + 1 < M) mv[j][half].y = __ldg(mr + 1);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = key0 + c * CHUNK + 8 * (j0 + j) + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float& s0 = s[c][4 * (j0 + j) + 2 * half];
            float& s1 = s[c][4 * (j0 + j) + 2 * half + 1];
            // (s + bias) + mask, in the plain version's order
            float a0 = s0 + __uint_as_float(bw[c][j0 + j][half] << 16);
            float a1 = s1 + __uint_as_float(bw[c][j0 + j][half] & 0xFFFF0000u);
            if (MASK) {
              a0 += mv[j][half].x;
              a1 += mv[j][half].y;
            }
            s0 = col < M ? a0 : -INFINITY;
            s1 = col + 1 < M ? a1 : -INFINITY;
            mx[half] = fmaxf(mx[half], fmaxf(s0, s1));
          }
        }
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    }
    if (KS > 1) {
      if (t == 0) {
        red_max[wg * ROWS + rt] = mx[0];
        red_max[wg * ROWS + rt + 8] = mx[1];
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = -INFINITY;
        for (int w = 0; w < KS; ++w) m = fmaxf(m, red_max[w * ROWS + rt + 8 * half]);
        mx[half] = m;
      }
    }

    // 4. exp(s - max), the row sums, then p = exp / sum
    float sum[2] = {0.f, 0.f};
    const float mlog[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        s[c][i] = ex2(fmaf(s[c][i], LOG2E, -mlog[half]));
        sum[half] += s[c][i];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    }
    if (KS > 1) {
      if (t == 0) {
        red_sum[wg * ROWS + rt] = sum[0];
        red_sum[wg * ROWS + rt + 8] = sum[1];
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float total = 0.f;
        for (int w = 0; w < KS; ++w) total += red_sum[w * ROWS + rt + 8 * half];
        sum[half] = total;
      }
    }
    const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
    // k16 step kk of a chunk: a0 = s[8kk], s[8kk+1] (row r0), a1 = s[8kk+2],
    // s[8kk+3] (r1), a2 = s[8kk+4], s[8kk+5] (r0), a3 = s[8kk+6], s[8kk+7] (r1)
    uint32_t pa[CPW][4][4];
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float f = inv[x & 1];
          pa[c][kk][x] = pack_bf16(s[c][8 * kk + 2 * x] * f, s[c][8 * kk + 2 * x + 1] * f);
        }

    // 5. O = P v over this warpgroup's keys
    float o[DK / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) {
      o[i] = 0.f;
      keep(o[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int step = (key0 + c * CHUNK) / 16 + kk;  // k16 step over the keys
        pv_mma<DK>(o, pa[c][kk], desc_sw64(s_v_u32 + (step >> 1) * DK * ROW) + 2 * (step & 1));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) keep(o[i]);
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) keep(pa[c][kk][x]);

    if (KS > 1) {
      if (wg > 0) {
#pragma unroll
        for (int i = 0; i < DK / 2; ++i) o_part[((wg - 1) * (DK / 2) + i) * 128 + wt] = o[i];
      }
      __syncthreads();
      if (wg == 0) {
        for (int w = 1; w < KS; ++w)
#pragma unroll
          for (int i = 0; i < DK / 2; ++i) o[i] += o_part[((w - 1) * (DK / 2) + i) * 128 + wt];
      }
    }
    // o[4j + 2 half + e]: row r[half], channel 8j + 2t + e
    if (wg == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r[half];
        if (row >= N) continue;
        __nv_bfloat16* orow = p.out + ((long long)b * N + row) * p.nh * d + h * d;
#pragma unroll
        for (int j = 0; j < DK / 8; ++j) {
          const int ch = 8 * j + 2 * t;
          const float o0 = o[4 * j + 2 * half], o1 = o[4 * j + 2 * half + 1];
          if (ch >= d) continue;
          if (pairs) {
            *reinterpret_cast<uint32_t*>(orow + ch) = pack_bf16(o0, o1);
          } else {
            orow[ch] = __float2bfloat16_rn(o0);
            if (ch + 1 < d) orow[ch + 1] = __float2bfloat16_rn(o1);
          }
        }
      }
    }
  }
}

template <int DK, int CPW, bool MASK>
cudaError_t launch(const Params& p, int pairs, int ks, cudaStream_t stream) {
  const auto kernel = window_attention_sm90_kernel<DK, CPW, MASK>;
  // per device: set on each launch, which costs the host little
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem_bytes(max_ks(DK, CPW), CPW, DK));
  if (err != cudaSuccess) return err;
  kernel<<<pairs, 128 * ks, smem_bytes(ks, CPW, DK), stream>>>(p);
  return cudaGetLastError();
}

template <int DK, int CPW>
cudaError_t launch(const Params& p, bool masked, int pairs, int ks, cudaStream_t stream) {
  return masked ? launch<DK, CPW, true>(p, pairs, ks, stream)
                : launch<DK, CPW, false>(p, pairs, ks, stream);
}

}  // namespace

extern "C" {

// Shapes, strides, alignment and the split (ks warpgroups of cpw chunks,
// ks * cpw * 64 >= M, every warpgroup with a chunk below M) are checked and
// chosen by the Python wrapper; dk is d padded to 32, 64 or 128, and pairs
// says q, k and v are read a pair of channels to a 32-bit load. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int window_attention(int device, const void* q, const void* k, const void* v, long long q_sb,
                     long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                     long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                     const void* bias, int ldb, const void* mask, long long m_sw, int m_sn,
                     int mask_pairs, int nw, void* out, int batch, int nh, int n, int m, int d,
                     int dk, int pairs, float scale, int ks, int cpw, void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if ((dk != 32 && dk != 64 && dk != 128) || d > dk || cpw < 1 || cpw > max_cpw(dk) ||
      ks < min_ks(dk, cpw) || ks > max_ks(dk, cpw))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sn = k_sn;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sn = v_sn;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.m_sw = m_sw, p.m_sn = m_sn, p.mask_pairs = mask_pairs;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.nh = nh, p.N = n, p.M = m, p.d = d, p.ldb = ldb, p.nW = nw, p.pairs = pairs;
  p.scale = scale;
  const int blocks = batch * nh;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool masked = mask != nullptr;
  cudaError_t err;
  if (dk == 32) {
    err = cpw == 1   ? launch<32, 1>(p, masked, blocks, ks, s)
          : cpw == 2 ? launch<32, 2>(p, masked, blocks, ks, s)
                     : launch<32, 3>(p, masked, blocks, ks, s);
  } else if (dk == 64) {
    err = cpw == 1 ? launch<64, 1>(p, masked, blocks, ks, s) : launch<64, 2>(p, masked, blocks, ks, s);
  } else {
    err = cpw == 1 ? launch<128, 1>(p, masked, blocks, ks, s)
                   : launch<128, 2>(p, masked, blocks, ks, s);
  }
  return static_cast<int>(err);
}

const char* window_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
