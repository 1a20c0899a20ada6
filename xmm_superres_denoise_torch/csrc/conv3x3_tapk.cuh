// K3's route at Cin % 128 != 0 (conv_first: the 4-channel S2D codes into
// 128 channels): a SAME 3x3 s8 convolution on wgmma m64n128k32 s8 whose K
// is ordered (tap, channel), for Hopper (sm_90a). conv_i8.cu owns the
// epilogue; Cin % 128 == 0 runs conv3x3_wgmma.cuh in s8 instead.
//
// GEMM view. M = output pixels, N = 128 output channels per block, K =
// (tap, channel): byte 4q..4q+3 of K is channels 4(q % (ch/4))..+3 of tap
// q / (ch/4), with Cin rounded up to a multiple of 4 (ch) and 9 * ch
// rounded up to 32 bytes (two k32 steps at Cin 4: 36 of 64 bytes used).
// Above 64 channels K is cut into chunks of 64 channels, each (tap,
// channel) within, Cin rounded up to a multiple of 64. The wrapper packs
// the weights once in that order, (Cout, chunks * kc) K-major, which is
// what wgmma wants of an 8-bit B.
//
// What bounds it. conv_first at (2, 208, 208, 4) -> 128 with bf16 values
// and int8 codes reads 0.35 MB and writes 33.2 MB: 9.9 us at 3.35 TB/s,
// against 0.7 us of its 1.4 G int8 operations (padded to 64 bytes of K:
// 2.8 G). It is bound by its stores, so the design is built around them:
// * an item is one m64 block, 4 rows x 16 px, taken by one warpgroup; two
//   warpgroups a block, two blocks an SM, a persistent grid over the
//   items (1,352 at the serving shape), each warpgroup on its own items
//   with only its own barrier, so one's stores overlap another's math;
// * each warp stages its int32 sums (its 16 px) in shared memory, and
//   then runs the epilogue a pixel at a time, each lane on 4 channels: a
//   store instruction writes a pixel's whole row (256 B of bf16 values,
//   128 B of codes) instead of the 4-byte pairs of 8 pixels that the
//   fragment layout holds, and each lane keeps its 4 channels' c_o and
//   bias in registers for the whole launch; what the epilogue writes (raw
//   sums; values, codes or both, f32 or bf16) is a template parameter, 7
//   instances: as runtime flags its branches split the unrolled pixels
//   into blocks the compiler could not interleave, and it ran markedly
//   slower; three conversions a value are exact identities (conv_i8.cu:
//   Epilogue::quad);
// * the next item's halo is in flight (cp.async, 4 bytes) while the
//   warpgroup runs its epilogue and stores;
// * the codes are read in place, 4 channels a 32-bit word, no padded copy:
//   one A register is one tap's 4 channels of one pixel, loaded from the
//   staged halo by one 32-bit shared load through a per-K-word offset
//   table, no ldmatrix; channels past Cin and pixels outside the image are
//   zeros in the halo (SAME padding);
// * the weights, 8 KB at Cin 4, stay resident in shared memory with the
//   128-byte swizzle of conv3x3_wgmma.cuh, copied there once a block.
// Above 64 channels (never on the int8 forward's path) each chunk's
// weights and halo are staged per item behind block barriers.
//
// Shared memory (dynamic), from a 1024-byte-aligned base: the weight
// slabs (16 KB each, 128 bytes of K for 128 channels), the offset table
// (kc / 4 ints), a halo of 6 x 18 px per warpgroup (an odd number of
// 32-bit words per pixel), and the sums of 16 px per warp (rows of 512 + 32
// B: the fragment's 8-byte stores meet no bank conflict). Cin 4: 87,968 B
// (two blocks an SM); the widest (64-channel chunks): 167,840 B.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace conv3x3_tapk {

using namespace wgmma;

constexpr int ROWS = 4, TW = 16;  // an item: 4 rows x 16 px, one m64 block
constexpr int HALO_H = ROWS + 2, HALO_W = TW + 2;
constexpr int HALO_PIX = HALO_H * HALO_W;  // 108
constexpr int BN = 128;                    // output channels per block
constexpr int CHMAX = 64;                  // input channels per K chunk
constexpr int WGS = 2;                     // warpgroups per block
constexpr int THREADS = 128 * WGS;
constexpr int WARPS = 4 * WGS;
constexpr int MIN_BLOCKS = 2;              // per SM: at most 128 registers a thread
constexpr int SLAB = BN * 128;             // 16 KB of weights: 128 bytes of K
constexpr int PX = 16;                     // pixels a warp stages: its row of the item
constexpr int SROW = 136;                  // ints per staged pixel: 128 sums and 8

// The route's layout for `cin` input channels.
struct Geometry {
  int ch;      // input channels per chunk, a multiple of 4
  int chunks;  // chunks over cin
  int kc;      // bytes of K per chunk: 9 * ch rounded up to 32
  int slabs;   // 16 KB weight slabs per chunk
  int rs;      // bytes per staged halo pixel: an odd number of words
  int tab_off, halo_off, halo_bytes, stage_off, smem;
};

__host__ __device__ inline Geometry geometry(int cin) {
  Geometry g;
  const int cin4 = (cin + 3) / 4 * 4;
  g.ch = cin4 < CHMAX ? cin4 : CHMAX;
  g.chunks = (cin4 + g.ch - 1) / g.ch;
  g.kc = (9 * g.ch + 31) / 32 * 32;
  g.slabs = (g.kc + 127) / 128;
  g.rs = (g.ch / 4) % 2 ? g.ch : g.ch + 4;
  g.tab_off = g.slabs * SLAB;
  g.halo_off = g.tab_off + g.kc;  // kc / 4 ints
  g.halo_bytes = (HALO_PIX * g.rs + 15) / 16 * 16;
  g.stage_off = g.halo_off + WGS * g.halo_bytes;
  g.smem = 1024 + g.stage_off + WARPS * PX * SROW * 4;
  return g;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The barrier of warpgroup `wg` alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

struct Item {
  int b, y0, x0;
};

__device__ __forceinline__ Item item_at(int item, int tiles_x, int bands) {
  const int xt = item % tiles_x, r = item / tiles_x;
  return {r / bands, (r % bands) * ROWS, xt * TW};
}

// What the kernel reads: x8 with `stride` bytes between pixels, channels
// [0, cin); w packed (cout, chunks * kc); `aligned` when x8 and stride are
// multiples of 4 (then whole words of 4 channels are copied as they are).
struct Src {
  const uint8_t* x8;
  int H, W, stride, cin;
  int aligned;
  const uint8_t* w;
  int items, tiles_x, bands;
};

// One warpgroup stages chunk c of the item's halo: 6 x 18 px x ch bytes,
// zeros outside the image and past cin. Whole words go by cp.async; a
// word past the end of cin, or any word of an unaligned input, is put
// together from bytes.
__device__ __forceinline__ void stage_halo(uint8_t* halo, const Src& s, const Geometry& g,
                                           const Item& it, int c, int wl) {
  const int wpp = g.ch / 4;
  for (int i = wl; i < HALO_PIX * wpp; i += 128) {
    const int p = i / wpp, wd = i - p * wpp;
    const int y = it.y0 - 1 + p / HALO_W, x = it.x0 - 1 + p % HALO_W;
    const int c0 = c * g.ch + 4 * wd;
    uint8_t* dst = halo + p * g.rs + 4 * wd;
    const bool in = y >= 0 && y < s.H && x >= 0 && x < s.W && c0 < s.cin;
    const uint8_t* src =
        in ? s.x8 + ((static_cast<size_t>(it.b) * s.H + y) * s.W + x) * s.stride + c0 : s.x8;
    if (s.aligned && (!in || c0 + 4 <= s.cin)) {
      cp_async4(dst, src, in ? 4 : 0);
    } else {
      uint32_t v = 0;
      if (in)
        for (int k = 0; k < 4 && c0 + k < s.cin; ++k) v |= static_cast<uint32_t>(src[k]) << (8 * k);
      *reinterpret_cast<uint32_t*>(dst) = v;
    }
  }
}

// The block stages chunk c of its 128 output channels' weights into the
// slabs with the 128-byte swizzle (wgmma::desc_sw128).
__device__ __forceinline__ void stage_weights(uint8_t* slabs, const Src& s, const Geometry& g,
                                              int n0, int c) {
  const int pieces = g.kc / 16;
  const size_t row = static_cast<size_t>(g.chunks) * g.kc;
  for (int i = threadIdx.x; i < BN * pieces; i += THREADS) {
    const int n = i / pieces, p = i - n * pieces;
    cp_async16(slabs + (p / 8) * SLAB + n * 128 + (((p % 8) ^ (n % 8)) << 4),
               s.w + (n0 + n) * row + static_cast<size_t>(c) * g.kc + 16 * p);
  }
}

// The A fragment of k-step `step`: rows g and g + 8 of the warp (`hrow`,
// its halo pixel at tap (0, 0)), K words 8 * step + t and + 4.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* hrow, int rs8,
                                       const int* tab, int step, int t) {
  const int o0 = tab[8 * step + t], o1 = tab[8 * step + t + 4];
  a[0] = o0 >= 0 ? *reinterpret_cast<const uint32_t*>(hrow + o0) : 0u;
  a[1] = o0 >= 0 ? *reinterpret_cast<const uint32_t*>(hrow + rs8 + o0) : 0u;
  a[2] = o1 >= 0 ? *reinterpret_cast<const uint32_t*>(hrow + o1) : 0u;
  a[3] = o1 >= 0 ? *reinterpret_cast<const uint32_t*>(hrow + rs8 + o1) : 0u;
}

__device__ __forceinline__ void mma_step(int (&acc)[64], const uint32_t (&a)[4], uint64_t desc) {
#pragma unroll
  for (int i = 0; i < 64; ++i) keep(acc[i]);
  wgmma_fence();
  wgmma_m64n128k32_s8(acc, a, desc);
  wgmma_commit();
}

// acc += the chunk's (64 x kc) x (kc x 128) product, two k-steps' A
// fragments in turn while the previous step's wgmma runs.
__device__ __forceinline__ void mma_chunk(int (&acc)[64], const uint8_t* hrow, int rs8,
                                          const int* tab, uint32_t slabs, int steps, int t) {
  uint32_t a0[4], a1[4] = {};
  load_a(a0, hrow, rs8, tab, 0, t);
  for (int s = 0; s < steps; s += 2) {
    mma_step(acc, a0, desc_sw128(slabs + (s / 4) * SLAB) + 2 * (s % 4));
    wgmma_wait<1>();  // step s - 1 is done: a1 is free
#pragma unroll
    for (int r = 0; r < 4; ++r) keep(a1[r]);
    if (s + 1 < steps) {
      load_a(a1, hrow, rs8, tab, s + 1, t);
      mma_step(acc, a1, desc_sw128(slabs + ((s + 1) / 4) * SLAB) + 2 * ((s + 1) % 4));
      wgmma_wait<1>();  // step s is done: a0 is free
#pragma unroll
      for (int r = 0; r < 4; ++r) keep(a0[r]);
      if (s + 2 < steps) load_a(a0, hrow, rs8, tab, s + 2, t);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) keep(acc[i]);
}

// The epilogue (Epi, conv_i8.cu) takes channels n..n+3 of a pixel inside
// the image: epi.quad<MODE>(pixel, n, sums, c_o, bias, small, vwide,
// cwide), MODE what it writes, with the lane's c_o and bias from
// epi.coeffs(n, c_o, bias); `small` says every |sum| < 2^22, `vwide` and
// `cwide` whether a lane's 4 values and 4 codes may be stored as one
// access.
template <class Epi, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conv3x3_tapk_kernel(const Src s, const Geometry g, int small, int vwide, int cwide, Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* slabs = base;
  int* tab = reinterpret_cast<int*>(base + g.tab_off);
  const int wg = threadIdx.x / 128, wl = threadIdx.x & 127;
  const int warp = wl >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  uint8_t* halo = base + g.halo_off + wg * g.halo_bytes;
  int* sums = reinterpret_cast<int*>(base + g.stage_off) + (wg * 4 + warp) * PX * SROW;
  const int n0 = blockIdx.y * BN;
  const uint32_t slabs_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(slabs));
  const int steps = g.kc / 32, wpp = g.ch / 4, rs8 = 8 * g.rs;
  const bool resident = g.chunks == 1;
  const int stride = gridDim.x * WGS;
  const uint8_t* hrow = halo + (warp * HALO_W + g8) * g.rs;
  float4 c_o, bias;
  epi.coeffs(n0 + 4 * lane, c_o, bias);

  for (int q = threadIdx.x; q < g.kc / 4; q += THREADS) {
    const int tap = q / wpp;
    tab[q] = tap < 9 ? ((tap / 3) * HALO_W + tap % 3) * g.rs + 4 * (q - tap * wpp) : -1;
  }
  int item = blockIdx.x * WGS + wg;
  if (resident) {
    stage_weights(slabs, s, g, n0, 0);
    if (item < s.items) stage_halo(halo, s, g, item_at(item, s.tiles_x, s.bands), 0, wl);
    cp_async_wait_all();
    fence_proxy_async();
  }
  __syncthreads();

  // the loop's bounds are the block's, so that both warpgroups meet every
  // block barrier of the chunked form; a warpgroup without an item idles
  for (int first = blockIdx.x * WGS; first < s.items; first += stride, item += stride) {
    const bool live = item < s.items;
    const Item it = item_at(item, s.tiles_x, s.bands);
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int c = 0; c < g.chunks; ++c) {
      if (resident) {
        cp_async_wait_all();  // this item's halo, staged during the last epilogue
        wg_barrier(wg);
      } else {
        __syncthreads();  // the previous chunk's weights and halos are read
        stage_weights(slabs, s, g, n0, c);
        if (live) stage_halo(halo, s, g, it, c, wl);
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();
      }
      if (live) mma_chunk(acc, hrow, rs8, tab, slabs_u32, steps, t);
    }
    if (!live) continue;
    if (resident) {
      wg_barrier(wg);  // every warp has read the halo
      if (item + stride < s.items)
        stage_halo(halo, s, g, item_at(item + stride, s.tiles_x, s.bands), 0, wl);
    }

    // acc[4j + 2*half + e]: pixel (y0 + warp, x0 + g8 + 8*half), channel
    // n0 + 8j + 2t + e; staged, then a pixel's 128 channels a step
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<int2*>(sums + (g8 + 8 * half) * SROW + 8 * j + 2 * t) =
            make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    __syncwarp();
    const int y = it.y0 + warp;
    const int npx = y < s.H ? min(PX, s.W - it.x0) : 0;
    const size_t pix0 = (static_cast<size_t>(it.b) * s.H + y) * s.W + it.x0;
#pragma unroll 4
    for (int p = 0; p < npx; ++p)
      epi.template quad<MODE>(pix0 + p, n0 + 4 * lane, *reinterpret_cast<const int4*>(sums + p * SROW + 4 * lane),
               c_o, bias, small, vwide, cwide);
    __syncwarp();
  }
}

// Launch on `stream` for x8 (B, H, W, cin) with `stride` bytes between
// pixels and w packed (cout, chunks * kc); MODE, `small`, `vwide`,
// `cwide` as for the kernel. Returns the cudaError_t of the launch.
template <class Epi, int MODE>
int launch(const void* x8, int B, int H, int W, int stride, int cin, const void* w, int cout,
           bool small, bool vwide, bool cwide, Epi epi, cudaStream_t stream) {
  if (cin < 1 || cout % BN || cin > stride) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(w) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const Geometry g = geometry(cin);
  const int tiles_x = (W + TW - 1) / TW, bands = (H + ROWS - 1) / ROWS;
  const long long items = static_cast<long long>(B) * bands * tiles_x;
  if (items > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const Src s{static_cast<const uint8_t*>(x8), H, W, stride, cin,
              reinterpret_cast<uintptr_t>(x8) % 4 == 0 && stride % 4 == 0,
              static_cast<const uint8_t*>(w), static_cast<int>(items), tiles_x, bands};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = conv3x3_tapk_kernel<Epi, MODE>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks an SM holds: MIN_BLOCKS by registers, fewer when shared memory
  // (228 KB an SM, 1 KB of it reserved per block) says so
  const int per_sm = std::max(1, std::min(MIN_BLOCKS, 233472 / (g.smem + 1024)));
  const int groups = cout / BN;
  const long long want = (items + WGS - 1) / WGS;
  const int blocks =
      static_cast<int>(std::min<long long>(want, std::max(1, per_sm * sms / groups)));
  kernel<<<dim3(blocks, groups), THREADS, g.smem, stream>>>(s, g, small, vwide, cwide, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv3x3_tapk
