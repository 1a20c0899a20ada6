// The s8 tensor-core warp tile shared by the int8 GEMM probe (int8_gemm.cu)
// and the s8 implicit-GEMM convolution's mma.sync route (conv_i8.cu,
// through conv3x3_igemm.cuh).
//
// One warp owns a 32 x (8 * N_TILES) tile of the output (two m16 tiles by
// N_TILES n8 tiles; N_TILES is a template parameter: 8 for a 32 x 64 tile,
// 4 for 32 x 32) and advances it by one k-step of 32 bytes of K:
//   s8: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (32 values)
// The instruction is a template parameter (`S8`). With g = lane / 4 and
// t = lane % 4:
//   A (16 rows x 32 bytes, row-major): a0 = row g, bytes 4t..4t+3;
//     a1 = row g+8, same bytes; a2 = row g, bytes 16+4t..; a3 = row g+8,
//     bytes 16+4t..
//   B (32 bytes of K x 8 columns, stored K-contiguous per column, i.e. the
//     "col" operand): b0 = column g, bytes 4t..4t+3; b1 = column g, bytes
//     16+4t..
//   D (16 x 8): d0, d1 = row g, columns 2t, 2t+1; d2, d3 = row g+8, same
//     columns.
// Rows of A and columns of B live in shared memory at any byte stride that
// is a multiple of 4; a stride of 16 bytes more than the K chunk (48, 80 or
// 144 bytes) puts the eight rows that one load touches on distinct banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mma_tile {

constexpr int WARP_M = 32;   // output rows of a warp (two m16 tiles)
constexpr int M_TILES = 2;
constexpr int K_BYTES = 32;  // bytes of K per k-step

struct S8 {
  using Acc = int;
  static __device__ __forceinline__ void mma(Acc (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <class Op, int N_TILES>
__device__ __forceinline__ void zero(typename Op::Acc (&acc)[M_TILES][N_TILES][4]) {
#pragma unroll
  for (int mi = 0; mi < M_TILES; ++mi)
#pragma unroll
    for (int ni = 0; ni < N_TILES; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
}

// One k-step of the warp tile. `a` points at row g of m-tile 0 and `b` at
// column g of n-tile 0, both already advanced to this k-step and to byte
// 4t. Row g+8 of an m-tile is `a_row8` bytes after row g, m-tile 1 is
// `a_mtile` bytes after m-tile 0, and n-tile j is j * `b_ntile` bytes after
// n-tile 0.
template <class Op, int N_TILES>
__device__ __forceinline__ void kstep(typename Op::Acc (&acc)[M_TILES][N_TILES][4],
                                      const uint8_t* a, int a_row8, int a_mtile,
                                      const uint8_t* b, int b_ntile) {
  uint32_t af[M_TILES][4];
#pragma unroll
  for (int mi = 0; mi < M_TILES; ++mi) {
    const uint8_t* p = a + mi * a_mtile;
    af[mi][0] = ld32(p);
    af[mi][1] = ld32(p + a_row8);
    af[mi][2] = ld32(p + 16);
    af[mi][3] = ld32(p + a_row8 + 16);
  }
#pragma unroll
  for (int ni = 0; ni < N_TILES; ++ni) {
    const uint8_t* q = b + ni * b_ntile;
    const uint32_t bf[2] = {ld32(q), ld32(q + 16)};
#pragma unroll
    for (int mi = 0; mi < M_TILES; ++mi) Op::mma(acc[mi][ni], af[mi], bf);
  }
}

// 16-byte asynchronous copy from global to shared memory; src_bytes = 0
// writes zeros (the halo outside the image).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

}  // namespace mma_tile
