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
// by the wrapper once for the route (below):
//   y32[b, y, x, o] = sum_{dy, dx, c} x8[b, y+dy-1, x+dx-1, c] * w[dy, dx, c, o]
// with zeros outside the image. Any Cin, Cout a multiple of 128.
// |sum| <= 9 * 640 * 127^2 ~ 9.3e7 fits int32. Then, per
// output element, the epilogue (Epilogue below) either stores y32 (raw) or
// runs the torch epilogue of ops/int8_forward.py rounding for rounding and
// stores its dtype value, its int8 code, or both (the value for the
// residual path, the code for the next convolution, which reads it in
// place).
//
// Routes, both on wgmma.mma_async.m64n128k32.s32.s8.s8 with A from
// registers, the instruction the probe P (int8_gemm.cu) checks:
// * cin % 128 == 0 (63 of the 64 convolutions of a forward): the wgmma
//   level of conv3x3_wgmma.cuh in s8 (16 x 16 px x 128 channels per block,
//   the halo as one 18 x 18 x 128-byte TMA box per chunk, double buffered,
//   whose zero fill is SAME padding, the weights packed (9, Cout, Cin) as
//   (tap, 128-channel) slices of 16 KB through a 6-stage TMA ring; its note
//   says what the design does). The epilogue takes the whole fragment.
// * any other cin (conv_first, Cin 4): conv3x3_tapk.cuh, K ordered (tap,
//   channel) with only the total padded (36 -> 64 bytes at Cin 4), the
//   weights packed (Cout, K) and resident in shared memory, the codes read
//   in place, and the epilogue's values and codes staged in shared memory
//   and stored as whole lines (its note says why: it is bound by stores).
//
// What bounds it on this card. At the trunk's level-5 shape, (2, 208, 208,
// 640) -> 128, it does 2 * (2*208*208) * 128 * (9*640) = 127.6 G int8 ops
// on 55.4 MB in and 22 MB out (bf16): ~1,650 ops per byte, above the ~590
// int8 ops per byte ridge of an H100 SXM (1,979 TOPS over 3.35 TB/s), so it
// is bound by operations (0.064 ms at the published peak). conv_first (Cin
// 4, 128 out) is bound by bytes. Keeping the epilogue here
// keeps the int32 sums in registers: a level writes 1 byte per output
// element (its int8 codes) or 2 (bf16) instead of 4 bytes of int32 that
// ~15 torch launches then read and write again.

#include <cuda_bf16.h>

#include "conv3x3_tapk.cuh"
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
// The (tap, channel) route stages the sums in shared memory and hands each
// lane four channels of one pixel at a time (`quad`), so that a warp's
// store covers a pixel's whole row. The 128-channel route hands over the
// thread's whole fragment (`fragment`): its pairs are taken 8 channel
// groups at a time, all their loads (c_o, bias, residual) issued before
// any of their stores, so a block's epilogue waits on memory 8 times
// rather than once per pair (64 times). The read-only
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

  // Steps 1-3 of one pair, its operands loaded.
  __device__ __forceinline__ float2 finish(int v0, int v1, float2 c, float2 b, float2 r) const {
    float f0 = value(v0, c.x, b.x), f1 = value(v1, c.y, b.y);
    if (res != nullptr) {
      f0 = round_dtype(__fadd_rn(round_dtype(__fmul_rn(f0, alpha)), r.x));
      f1 = round_dtype(__fadd_rn(round_dtype(__fmul_rn(f1, alpha)), r.y));
    }
    return make_float2(f0, f1);
  }

  __device__ __forceinline__ char2 codes2(float2 f) const {
    return make_char2(static_cast<signed char>(code(f.x)), static_cast<signed char>(code(f.y)));
  }

  // Steps 1-4 and the stores of one pair, its operands loaded.
  __device__ __forceinline__ void pair(size_t pix, int n, int v0, int v1, float2 c, float2 b,
                                       float2 r) const {
    const float2 f = finish(v0, v1, c, b, r);
    if (codes != nullptr) *reinterpret_cast<char2*>(codes + pix * codes_stride + n) = codes2(f);
    if (dst == nullptr) return;
    if (bf16) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dst) + pix * dst_stride + n) =
          __floats2bfloat162_rn(f.x, f.y);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(dst) + pix * dst_stride + n) = f;
    }
  }

  // c_o and bias of channels n..n+3 (zeros for the raw sums).
  __device__ __forceinline__ void coeffs(int n, float4& c, float4& b) const {
    c = b = make_float4(0.f, 0.f, 0.f, 0.f);
    if (raw) return;
    const float2 c0 = __ldg(reinterpret_cast<const float2*>(c_o + n));
    const float2 c1 = __ldg(reinterpret_cast<const float2*>(c_o + n + 2));
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(bias + n));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + n + 2));
    c = make_float4(c0.x, c0.y, c1.x, c1.y);
    b = make_float4(b0.x, b0.y, b1.x, b1.y);
  }

  // What quad writes, a template parameter of the route's kernel so that
  // four pixels' quads unroll into one block of code that the compiler can
  // interleave (runtime flags would split it at every branch).
  static constexpr int RAW = 1, VALUES = 2, CODES = 4, BF16 = 8;

  int mode() const {
    if (raw) return RAW;
    return (dst != nullptr ? VALUES : 0) | (codes != nullptr ? CODES : 0) | (bf16 ? BF16 : 0);
  }

  // Four channels n..n+3 of pixel pix (the (tap, channel) route,
  // conv3x3_tapk.cuh: one lane's share of a pixel's row), their sums in v,
  // their c_o and bias in c and b: steps 1-4 and the stores, each as one
  // access when `vwide` / `cwide` say the outputs' alignment allows (4
  // values; 4 codes), else as pairs. Three conversions a value (a quarter
  // of the FP32 rate each) become exact identities, which made the route
  // measurably faster at conv_first: `small` (every |sum| < 2^22, so
  // 1.5 * 2^23 + y is exactly representable) makes float(y) an integer add
  // and a float add; a code is clamped first, then rounded half to even by
  // adding 1.5 * 2^23, whose low byte is then the code (clamping before or
  // after rounding gives the same code, NaN included); values already
  // rounded to bf16 are packed by their high halves.
  __device__ __forceinline__ float fsum(int y, bool small) const {
    return small ? __fadd_rn(__int_as_float(0x4B400000 + y), -12582912.f) : __int2float_rn(y);
  }

  __device__ __forceinline__ uint32_t code_byte(float v) const {
    const float t = fminf(fmaxf(__fmul_rn(v, qmul), -127.f), 127.f);
    return __float_as_uint(__fadd_rn(t, 12582912.f)) & 0xFFu;
  }

  template <int MODE>
  __device__ __forceinline__ void quad(size_t pix, int n, int4 v, float4 c, float4 b, bool small,
                                       bool vwide, bool cwide) const {
    if constexpr (MODE == RAW) {
      int* p = static_cast<int*>(dst) + pix * dst_stride + n;
      if (vwide) {
        *reinterpret_cast<int4*>(p) = v;
      } else {
        *reinterpret_cast<int2*>(p) = make_int2(v.x, v.y);
        *reinterpret_cast<int2*>(p + 2) = make_int2(v.z, v.w);
      }
      return;
    }
    constexpr bool kBf16 = (MODE & BF16) != 0;
    const auto round = [](float x) {
      return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
    };
    float f[4] = {fsum(v.x, small), fsum(v.y, small), fsum(v.z, small), fsum(v.w, small)};
    const float cc[4] = {c.x, c.y, c.z, c.w}, bb[4] = {b.x, b.y, b.z, b.w};
    float2 r0 = make_float2(0.f, 0.f), r1 = r0;
    if (res != nullptr) r0 = load_res(pix, n), r1 = load_res(pix, n + 2);
    const float rr[4] = {r0.x, r0.y, r1.x, r1.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = round(__fadd_rn(__fmul_rn(f[i], cc[i]), bb[i]));
      if (lrelu && !(f[i] >= 0.f)) f[i] = round(__fmul_rn(f[i], slope));
      if (res != nullptr) f[i] = round(__fadd_rn(round(__fmul_rn(f[i], alpha)), rr[i]));
    }
    if constexpr ((MODE & CODES) != 0) {
      int8_t* q = codes + pix * codes_stride + n;
      const uint32_t word = code_byte(f[0]) | code_byte(f[1]) << 8 | code_byte(f[2]) << 16 |
                            code_byte(f[3]) << 24;
      if (cwide) {
        *reinterpret_cast<uint32_t*>(q) = word;
      } else {
        *reinterpret_cast<uint16_t*>(q) = static_cast<uint16_t>(word);
        *reinterpret_cast<uint16_t*>(q + 2) = static_cast<uint16_t>(word >> 16);
      }
    }
    if constexpr ((MODE & VALUES) != 0 && kBf16) {  // f holds bf16 values: their high halves
      const uint32_t h0 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      const uint32_t h1 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
      uint32_t* p =
          reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dst) + pix * dst_stride + n);
      if (vwide) {
        *reinterpret_cast<uint2*>(p) = make_uint2(h0, h1);
      } else {
        p[0] = h0;
        p[1] = h1;
      }
    } else if constexpr ((MODE & VALUES) != 0) {
      float* p = static_cast<float*>(dst) + pix * dst_stride + n;
      if (vwide) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
        *reinterpret_cast<float2*>(p + 2) = make_float2(f[2], f[3]);
      }
    }
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
// [0, cin); w: packed int8, (9, cout, cin) when cin % 128 == 0, else
// (cout, K) in (tap, channel) order (ops/conv_i8.py: pack_weights); out:
// (B, H, W, cout) int32 (raw) or of the dtype, out_stride elements between
// pixels, or null; codes: (B, H, W, cout) int8, codes_stride bytes between
// pixels, or null; c_o, bias: (cout,) f32 (unused when raw); res: (B, H, W,
// cout) of the dtype with res_stride elements between pixels, or null.
// Shapes and alignment are checked by the Python wrapper: cout % 128 ==
// 0, 16-byte aligned w; at cin % 128 == 0 src_stride % 16 == 0 and a
// 16-byte aligned x8; even out_stride, codes_stride and res_stride,
// pair-aligned out, codes, res, c_o and bias. Returns the cudaError_t of
// the launch.
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
  // the widest single access each output's alignment allows a lane's four
  // channels: 4 values (8 or 16 bytes), 4 codes (4 bytes)
  const int vb = raw ? 4 : bf16 ? 2 : 4;
  const uintptr_t v = reinterpret_cast<uintptr_t>(out) | (static_cast<uintptr_t>(out_stride) * vb);
  const uintptr_t q = reinterpret_cast<uintptr_t>(codes) | static_cast<uintptr_t>(codes_stride);
  // every |sum| <= 9 * cin * 128^2 < 2^22 (cin <= 28: conv_first)
  const bool small = 9LL * cin * 128 * 128 < (1LL << 22);
  const bool vwide = v % (4 * vb) == 0, cwide = q % 4 == 0;
  using E = Epilogue;
#define TAPK(MODE)                                                                          \
  case MODE:                                                                                \
    return conv3x3_tapk::launch<E, MODE>(x8, B, H, W, src_stride, cin, w, cout, small, vwide, \
                                         cwide, epi, s)
  switch (epi.mode()) {
    TAPK(E::RAW);
    TAPK(E::VALUES);
    TAPK(E::CODES);
    TAPK(E::VALUES | E::CODES);
    TAPK(E::BF16 | E::VALUES);
    TAPK(E::BF16 | E::CODES);
    TAPK(E::BF16 | E::VALUES | E::CODES);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TAPK
}

// 1 if a convolution over `cin` input channels takes the 128-channel
// wgmma level, 0 for the (tap, channel) route.
int conv_i8_wgmma_route(int cin) { return wgmma_route(cin) ? 1 : 0; }

// Dynamic shared memory that one block of the route for `cin` asks for.
int conv_i8_smem_bytes(int cin) {
  return wgmma_route(cin) ? conv3x3_wgmma::SMEM : conv3x3_tapk::geometry(cin).smem;
}

const char* conv_i8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
