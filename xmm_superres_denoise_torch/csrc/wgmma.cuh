// Warpgroup MMA (wgmma) helpers for Hopper (sm_90a), shared by every kernel
// of the port that multiplies on the tensor cores: the bf16 and s8 levels of
// conv3x3_wgmma.cuh (K1, K2 at C % 128 == 0, K3 at Cin % 128 == 0), the bf16
// level at C = 32 (conv3x3_wgmma32.cuh), K3's (tap, channel) route at other
// Cin (conv3x3_tapk.cuh) and the int8 probe P (int8_gemm.cu), which checks
// the very instruction K3 serves on: wgmma.mma_async.m64n128k32.s32.s8.s8.
//
// A wgmma reads B from shared memory through a descriptor and A from
// registers (the RS form); the accumulators stay in registers. Four warps
// issue one together, asynchronously: wgmma_fence before a group,
// wgmma_commit after it, wgmma_wait<N> until at most N groups are still in
// flight. Shared memory written by threads (st.shared, cp.async) reaches
// the asynchronous proxy that wgmma reads through only after
// fence_proxy_async (then a barrier); TMA writes need no fence.
//
// Register fragments, with g = lane / 4 and t = lane % 4 of warp w of the
// warpgroup (rows 16w..16w+15 of the m64 tile):
//   A, 32 bytes of K (k16 bf16, k32 s8): a0 = row g, bytes 4t..4t+3;
//     a1 = row g+8, same bytes; a2 = row g, bytes 16+4t..; a3 = row g+8,
//     bytes 16+4t..
//   D, n128: d[4j + 2*half + e] = row g + 8*half, column 8j + 2t + e.
#pragma once

#include <cstdint>

namespace wgmma {

// Keep a register's value where it is until this point: the registers an
// in-flight wgmma reads or writes must not be reused or moved by the
// compiler before the wgmma.wait_group that covers it.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(int& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// asynchronous proxy (wgmma's descriptor reads); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major B slice with the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); the leading byte
// offset is unused for this layout. Byte k of row r lies at
// r * 128 + ((k / 16) ^ (r % 8)) * 16 + k % 16 of its 1024-byte-aligned
// slice, as a TMA box with CU_TENSOR_MAP_SWIZZLE_128B writes it. A 32-byte
// k-step advances the start address by 32 bytes, i.e. the descriptor by 2.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 rows x 128 f32, this thread's 64) += a (64 x 16 bf16 in registers,
// this warp's 16 rows) * B (16 x 128 through `desc`).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 rows x 128 s32, this thread's 64) += a (64 x 32 s8 in registers,
// this warp's 16 rows) * B (32 x 128 s8 through `desc`). Integer wgmma
// takes no scale or transpose immediates; both operands are K-major.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace wgmma
