// K3: a SAME 3x3 convolution of int8 activations with int8 weights, with
// the int8 forward's per-convolution epilogue inside the kernel, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces: ops/int8_forward.py::_conv_i8 of the JAX package, the XLA
// s8 x s8 -> s32 convolution (conv_general_dilated with
// preferred_element_type=int32) that carries every convolution of int8
// serving, together with the elementwise epilogue that XLA fuses into it
// (ops/int8_forward.py: forward, `(_conv_i8(x8, w8).astype(f32) * c_o +
// b).astype(dtype)`, `_lrelu`, the residuals and `_quantize`). PyTorch has
// no CUDA int8 convolution, so this is a hand kernel.
//
// What it computes. x8 (B, H, W, Cin) NHWC int8, with any pixel stride (so
// a channel prefix of a wider buffer can be read in place), weights packed
// by the wrapper once as (9, Cout, Cin) int8:
//   y32[b, y, x, o] = sum_{dy, dx, c} x8[b, y+dy-1, x+dx-1, c] * w[dy, dx, c, o]
// with zeros outside the image. Cin is a multiple of 32 (the wrapper pads
// conv_first's 4 channels to 32 with zeros, which adds nothing), Cout a
// multiple of 128. |sum| <= 9 * 640 * 127^2 ~ 9.3e7 fits int32. Then, per
// output element, the epilogue (Epilogue below) either stores y32 (raw) or
// runs the torch epilogue of ops/int8_forward.py rounding for rounding and
// stores its dtype value, its int8 code, or both (the value for the
// residual path, the code for the next convolution, which reads it in
// place).
//
// Routes. cin % 128 == 0 (63 of the 64 convolutions of a forward): the
// wgmma level of conv3x3_wgmma.cuh in s8 (16 x 16 px x 128 channels per
// block, wgmma.mma_async.m64n128k32.s32.s8.s8 with A from registers, the
// halo as one 18 x 18 x 128-byte TMA box per chunk, double buffered, whose
// zero fill is SAME padding, the weights as (tap, 128-channel) slices of
// 16 KB through a 6-stage TMA ring; its note says what the design does).
// Otherwise (conv_first, cin 32 after padding): the mma.sync implicit GEMM
// of conv3x3_igemm.cuh on its Tile128 (8 x 16 px x 128 channels,
// mma.sync m16n8k32 s8 -> s32). Both take the same epilogue functor.
//
// What bounds it on this card. At the trunk's level-5 shape, (2, 208, 208,
// 640) -> 128, it does 2 * (2*208*208) * 128 * (9*640) = 127.6 G int8 ops
// on 55.4 MB in and 22 MB out (bf16): ~1,650 ops per byte, above the ~590
// int8 ops per byte ridge of an H100 SXM (1,979 TOPS over 3.35 TB/s), so it
// is bound by operations (0.064 ms at the published peak). conv_first (Cin
// 4, padded to 32, 128 out) is bound by bytes. Keeping the epilogue here
// keeps the int32 sums in registers: a level writes 1 byte per output
// element (its int8 codes) or 2 (bf16) instead of 4 bytes of int32 that
// ~15 torch launches then read and write again.

#include <cuda_bf16.h>

#include "conv3x3_igemm.cuh"
#include "conv3x3_wgmma.cuh"
#include "device_guard.cuh"

namespace {

// The int8 forward's epilogue of one convolution, with runtime parameters,
// applied to each pair of s32 sums (output channels n, n + 1):
//   1. v = round_dtype(round_f32(round_f32(float_rn(y32) * c_o[n]) + b[n]))
//   2. lrelu: v = v >= 0 ? v : round_dtype(v * slope)
//   3. res:   v = round_dtype(round_dtype(v * alpha) + r)   (alpha = 1: r + v)
//   4. codes: q = clamp(rint(round_f32(v * qmul)), -127, 127) as int8
// then stores v (dst), q (codes) or both, which is, step by step, the torch
// op sequence of the plain version
// (ops/conv_i8.py: Epilogue.apply): two f32 launches for `* c_o` and `+ b`
// (so __fmul_rn / __fadd_rn, never a contracted FMA), products and sums of
// dtype values in f32 rounded to the dtype, and `_quantize`'s f32 product
// rounded half to even. slope, alpha and qmul come from the wrapper already
// rounded to the dtype (qmul to f32), as torch rounds its scalars.
// raw stores y32 as it is into dst (the raw convolution).
//
// The wgmma route hands over the thread's whole fragment (`fragment`): its
// pairs are taken 8 channel groups at a time, all their loads (c_o, bias,
// residual) issued before any of their stores, so a block's epilogue waits
// on memory 8 times rather than once per pair (64 times). The read-only
// loads go through the non-coherent cache: the wrapper refuses a residual
// that shares memory with an output.
struct Epilogue {
  static constexpr bool kFragment = true;
  static constexpr int GROUPS = 8;  // channel groups whose loads are issued together

  void* dst;         // int32 (raw) or the dtype; null: no values
  int dst_stride;    // elements between pixels
  int8_t* codes;     // int8 codes; null: none
  int codes_stride;  // bytes between pixels
  int raw;
  int bf16;          // the epilogue's dtype: bf16 (1) or f32 (0)
  const float* c_o;
  const float* bias;
  int lrelu;
  float slope;
  const void* res;  // dtype, res_stride elements between pixels; null: no residual
  int res_stride;
  float alpha;
  float qmul;

  __device__ __forceinline__ float round_dtype(float v) const {
    return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }

  __device__ __forceinline__ float value(int y, float c, float b) const {
    float v = round_dtype(__fadd_rn(__fmul_rn(__int2float_rn(y), c), b));
    if (lrelu && !(v >= 0.f)) v = round_dtype(__fmul_rn(v, slope));
    return v;
  }

  __device__ __forceinline__ int code(float v) const {
    return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, qmul)), -127.f), 127.f));
  }

  __device__ __forceinline__ float2 load_res(size_t pix, int n) const {
    if (bf16)
      return __bfloat1622float2(
          __ldg(static_cast<const __nv_bfloat162*>(res) + (pix * res_stride + n) / 2));
    return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(res) + pix * res_stride + n));
  }

  __device__ __forceinline__ void store_i32(size_t pix, int n, int v0, int v1) const {
    *reinterpret_cast<int2*>(static_cast<int*>(dst) + pix * dst_stride + n) = make_int2(v0, v1);
  }

  // Steps 1-4 and the stores of one pair, its operands loaded.
  __device__ __forceinline__ void pair(size_t pix, int n, int v0, int v1, float2 c, float2 b,
                                       float2 r) const {
    float f0 = value(v0, c.x, b.x), f1 = value(v1, c.y, b.y);
    if (res != nullptr) {
      f0 = round_dtype(__fadd_rn(round_dtype(__fmul_rn(f0, alpha)), r.x));
      f1 = round_dtype(__fadd_rn(round_dtype(__fmul_rn(f1, alpha)), r.y));
    }
    if (codes != nullptr)
      *reinterpret_cast<char2*>(codes + pix * codes_stride + n) =
          make_char2(static_cast<signed char>(code(f0)), static_cast<signed char>(code(f1)));
    if (dst == nullptr) return;
    if (bf16) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dst) + pix * dst_stride + n) =
          __floats2bfloat162_rn(f0, f1);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(dst) + pix * dst_stride + n) =
          make_float2(f0, f1);
    }
  }

  // One pair (the mma.sync route).
  __device__ __forceinline__ void operator()(size_t pix, int n, int v0, int v1) const {
    if (raw) return store_i32(pix, n, v0, v1);
    const float2 r = res != nullptr ? load_res(pix, n) : make_float2(0.f, 0.f);
    pair(pix, n, v0, v1, __ldg(reinterpret_cast<const float2*>(c_o + n)),
         __ldg(reinterpret_cast<const float2*>(bias + n)), r);
  }

  // The thread's wgmma fragment (conv3x3_wgmma.cuh: TakesFragment):
  // d[mb][4j + 2*half + e] is pixel (y + 4*mb, x + 8*half) of image rows
  // from `img` = b * H, channel n + 8j + e.
  __device__ __forceinline__ void fragment(const int (&d)[2][64], size_t img, int H, int W, int y,
                                           int x, int n) const {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      if (y + 4 * mb >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (x + 8 * half >= W) continue;
        const size_t pix = (img + y + 4 * mb) * W + x + 8 * half;
        if (raw) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            store_i32(pix, n + 8 * j, d[mb][4 * j + 2 * half], d[mb][4 * j + 2 * half + 1]);
          continue;
        }
#pragma unroll
        for (int j0 = 0; j0 < 16; j0 += GROUPS) {
          float2 c[GROUPS], b[GROUPS], r[GROUPS];
#pragma unroll
          for (int j = 0; j < GROUPS; ++j) {
            const int nj = n + 8 * (j0 + j);
            c[j] = __ldg(reinterpret_cast<const float2*>(c_o + nj));
            b[j] = __ldg(reinterpret_cast<const float2*>(bias + nj));
            r[j] = res != nullptr ? load_res(pix, nj) : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < GROUPS; ++j)
            pair(pix, n + 8 * (j0 + j), d[mb][4 * (j0 + j) + 2 * half],
                 d[mb][4 * (j0 + j) + 2 * half + 1], c[j], b[j], r[j]);
        }
      }
    }
  }
};

bool wgmma_route(int cin) { return cin % conv3x3_wgmma::S8::KC == 0; }

}  // namespace

extern "C" {

// x8: int8 with `src_stride` bytes between pixels, read over channels
// [0, cin); w: packed (9, cout, cin) int8; out: (B, H, W, cout) int32 (raw)
// or of the dtype, out_stride elements between pixels, or null; codes:
// (B, H, W, cout) int8, codes_stride bytes between pixels, or null; c_o,
// bias: (cout,) f32 (unused when raw); res: (B, H, W, cout) of the dtype
// with res_stride elements between pixels, or null. Shapes and alignment
// are checked by the Python wrapper: cin % 32 == 0, cout % 128 == 0,
// src_stride % 16 == 0, 16-byte aligned x8 and w, even out_stride,
// codes_stride and res_stride, pair-aligned out, codes, res, c_o and bias.
// Returns the cudaError_t of the launch.
int conv_i8(int device, const void* x8, int B, int H, int W, int src_stride, int cin,
            const void* w, int cout, void* out, int out_stride, void* codes, int codes_stride,
            int raw, int bf16, const void* c_o, const void* bias, int lrelu, float slope,
            const void* res, int res_stride, float alpha, float qmul, void* stream) {
  const DeviceGuard guard(device);  // the caller's device again on every return
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const Epilogue epi{out, out_stride, static_cast<int8_t*>(codes), codes_stride, raw, bf16,
                     static_cast<const float*>(c_o), static_cast<const float*>(bias),
                     lrelu, slope, res, res_stride, alpha, qmul};
  const auto s = static_cast<cudaStream_t>(stream);
  if (wgmma_route(cin))
    return conv3x3_wgmma::launch<conv3x3_wgmma::S8>(x8, B, H, W, src_stride, cin, w, cout, epi, s);
  return igemm::launch<mma_tile::S8, 32, igemm::Tile128>(x8, B, H, W, src_stride, cin, w, cout,
                                                         epi, s);
}

// 1 if a convolution over `cin` input channels (after padding) takes the
// wgmma route, 0 for the mma.sync Tile128.
int conv_i8_wgmma_route(int cin) { return wgmma_route(cin) ? 1 : 0; }

// Dynamic shared memory that one block of the route for `cin` asks for.
int conv_i8_smem_bytes(int cin) {
  return wgmma_route(cin) ? conv3x3_wgmma::SMEM : igemm::Geometry<igemm::Tile128, 32>::SMEM;
}

const char* conv_i8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
