// The requantization epilogues shared by the int8 kernels: the bit-exact
// TFLite one (Epilogue), the float32 one of fast numerics (FastEpilogue),
// and the float32-output one of dynamic-range (hybrid) models
// (HybridEpilogue, the GEMM's; HybridConvEpilogue, the conv's).  The
// kernels take one as a template parameter; ``Out`` is the type of the
// output element it gives.
//
// Replaces the requant that band_tpu traces into every exact Pallas
// kernel (band_tpu/ops/quant.py:286 multiply_by_quantized_multiplier and
// :327 requantize_exact).  The TPU builds 64-bit products from 32-bit
// limbs; Hopper has 64-bit integer multiply, so each rounding is one
// product, one add and one arithmetic shift.  The formulas are those of
// band_tpu_torch/ops/quant.py, which the CPU tests hold against the JAX
// package over the whole int32 range.
#pragma once

#include <cstdint>

namespace band {

enum Rounding : int { kSingle = 0, kDouble = 1, kRuy = 2 };

// Low 32 bits of a 64-bit value, as int32 (the int32 wrap of the JAX code).
__device__ __forceinline__ int32_t wrap32(long long v) {
  return static_cast<int32_t>(
      static_cast<uint32_t>(static_cast<unsigned long long>(v)));
}

// x * qm * 2^(shift - 31), TFLite rounding.  qm is in [0, 2^31).
//   single:     floor((x*qm + 2^(t-1)) / 2^t), t = 31 - shift in [1, 62]
//   double/ruy: x <<= max(shift, 0) in int32; with r = max(-shift, 0) and
//               P = x*qm, SRDHM then the rounding shift collapse to
//               floor((P + 2^30 + [r>0]*2^(30+r)
//                      - [double and r>0 and P+2^30<0]*2^31) / 2^(31+r)).
__device__ __forceinline__ int32_t mbqm(int32_t x, int32_t qm, int32_t shift,
                                        int rounding) {
  if (rounding == kSingle) {
    const int t = 31 - shift;
    const long long p = static_cast<long long>(x) * qm;
    return wrap32((p + (1LL << (t - 1))) >> t);
  }
  const int left = shift > 0 ? shift : 0;
  const int right = shift < 0 ? -shift : 0;
  const int32_t shifted =
      static_cast<int32_t>(static_cast<uint32_t>(x) << left);
  const long long sum0 = static_cast<long long>(shifted) * qm + (1LL << 30);
  long long add = right > 0 ? (1LL << (30 + right)) : 0LL;
  if (rounding == kDouble && right > 0 && sum0 < 0) add -= (1LL << 31);
  return wrap32((sum0 + add) >> (31 + right));
}

// clamp(mbqm(acc) + out_zp, qmin, qmax); the zero-point add wraps in int32.
__device__ __forceinline__ int32_t requantize(int32_t acc, int32_t qm,
                                              int32_t shift, int out_zp,
                                              int qmin, int qmax,
                                              int rounding) {
  const int32_t v = static_cast<int32_t>(
      static_cast<uint32_t>(mbqm(acc, qm, shift, rounding)) +
      static_cast<uint32_t>(out_zp));
  return v < qmin ? qmin : (v > qmax ? qmax : v);
}

// Per-output-channel requant parameters.  qm and shift hold one entry
// (per-tensor quantization, qstride 0) or one per channel (qstride 1).
struct Epilogue {
  using Out = int8_t;
  const int32_t* bias;
  const int32_t* qm;
  const int32_t* shift;
  int qstride;
  int w_zp;
  int out_zp;
  int qmin;
  int qmax;
  int rounding;

  // channel c's parameters, for a kernel that loads them once per column
  struct Params {
    int32_t bias, qm, shift;
  };
  __device__ __forceinline__ Params params(int c) const {
    return Params{bias[c], qm[c * qstride], shift[c * qstride]};
  }

  // acc: the raw s8 x s8 sum; wsum: the window (row) sum of the input,
  // which the weight zero point multiplies.  Returns the output byte.
  __device__ __forceinline__ int8_t apply(int32_t acc, int32_t wsum,
                                          const Params& p) const {
    const uint32_t a = static_cast<uint32_t>(acc) -
                       static_cast<uint32_t>(w_zp) * static_cast<uint32_t>(wsum) +
                       static_cast<uint32_t>(p.bias);
    const int32_t q = requantize(static_cast<int32_t>(a), p.qm, p.shift,
                                 out_zp, qmin, qmax, rounding);
    return static_cast<int8_t>(static_cast<uint8_t>(q));
  }

  __device__ __forceinline__ int8_t operator()(int32_t acc, int32_t wsum,
                                               int c) const {
    return apply(acc, wsum, params(c));
  }

  // the conv kernels' per-image hooks (qconv_mma.cuh): nothing depends on
  // the image, and padded taps read the static x_zp
  __device__ __forceinline__ void bind(int) {}
  __device__ __forceinline__ int fill(int x_zp) const { return x_zp; }
};

// Fast-numerics epilogue: the float32 requant of band_tpu's fast path
// (band_tpu/ops/quant.py:344 requantize_fast, and the epilogue of the
// Pallas kernel band_tpu/ops/pallas/qmatmul.py:26 _qmatmul_kernel):
//   a = acc - w_zp * wsum + bias            (int32, wrapping)
//   v = round_half_even(float32(a) * mult)  (one rounded product, no FMA)
//   out = clamp(v + out_zp, qmin, qmax)
// Only the _rn intrinsics are used, so nvcc contracts nothing and the
// result equals torch.round(a.float() * mult) bit for bit.  A product
// beyond int32 saturates in __float2int_rn and the add is 64-bit, so the
// clamp sees the right sign whatever the size.  mult holds one entry
// (per-tensor, mstride 0) or one per channel (mstride 1).
struct FastEpilogue {
  using Out = int8_t;
  const int32_t* bias;
  const float* mult;
  int mstride;
  int w_zp;
  int out_zp;
  int qmin;
  int qmax;

  struct Params {
    int32_t bias;
    float mult;
  };
  __device__ __forceinline__ Params params(int c) const {
    return Params{bias[c], mult[c * mstride]};
  }

  __device__ __forceinline__ int8_t apply(int32_t acc, int32_t wsum,
                                          const Params& p) const {
    const uint32_t a = static_cast<uint32_t>(acc) -
                       static_cast<uint32_t>(w_zp) * static_cast<uint32_t>(wsum) +
                       static_cast<uint32_t>(p.bias);
    const int v = __float2int_rn(
        __fmul_rn(__int2float_rn(static_cast<int32_t>(a)), p.mult));
    const long long q = static_cast<long long>(v) + out_zp;
    const long long r = q < qmin ? qmin : (q > qmax ? qmax : q);
    return static_cast<int8_t>(static_cast<uint8_t>(r));
  }

  __device__ __forceinline__ int8_t operator()(int32_t acc, int32_t wsum,
                                               int c) const {
    return apply(acc, wsum, params(c));
  }

  __device__ __forceinline__ void bind(int) {}
  __device__ __forceinline__ int fill(int x_zp) const { return x_zp; }
};

// Dynamic-range (hybrid) epilogue: float activations quantized per row
// at run time (q, zp[r], scale[r] for quantized row r, which covers `rows`
// consecutive GEMM rows), int8 weights with a float32 scale per column.
// band_tpu's hybrid FULLY_CONNECTED (band_tpu/ops/lowerings.py:971-995,
// its bias and fused activation :1045-1054), in its order of operations:
//   v = float32(acc)                       (__int2float_rn)
//   v = v - zp[r] * float32(rowsum[n])     (asymmetric rows only)
//   v = v * (scale[r] * w_scale[n])
//   v = v + bias[n]                        (when there is a bias)
//   out = act(v)                           (NONE, RELU or RELU6)
// Each step is one _rn intrinsic, so nvcc contracts nothing into an FMA
// and the result equals the same float32 steps in PyTorch bit for bit.
// The weights have no zero point: the kernel's rowsum(A) MMA stays off.
struct HybridEpilogue {
  using Out = float;
  static constexpr int w_zp = 0;
  const float* bias;       // [N], or null
  const float* w_scale;    // [N]
  const int32_t* rowsum;   // [N] column sums of B, or null (symmetric rows)
  const float* zp;         // [M / rows], or null (symmetric rows)
  const float* scale;      // [M / rows]
  int rows;
  int act;                 // 0 NONE, 1 RELU, 2 RELU6

  struct Params {
    float bias, w_scale, rowsum;
  };
  __device__ __forceinline__ Params params(int c) const {
    return Params{bias != nullptr ? bias[c] : 0.f, w_scale[c],
                  rowsum != nullptr ? __int2float_rn(rowsum[c]) : 0.f};
  }
  struct Row {
    float zp, scale;
  };
  __device__ __forceinline__ Row row(int m) const {
    const int r = m / rows;
    return Row{zp != nullptr ? zp[r] : 0.f, scale[r]};
  }

  __device__ __forceinline__ float apply(int32_t acc, const Params& p,
                                         const Row& r) const {
    float v = __int2float_rn(acc);
    if (zp != nullptr) v = __fsub_rn(v, __fmul_rn(r.zp, p.rowsum));
    v = __fmul_rn(v, __fmul_rn(r.scale, p.w_scale));
    if (bias != nullptr) v = __fadd_rn(v, p.bias);
    if (act == 1) v = v < 0.f ? 0.f : v;
    if (act == 2) v = v < 0.f ? 0.f : (v > 6.f ? 6.f : v);
    return v;
  }
};

// Dynamic-range (hybrid) epilogue of the conv (qconv_mma.cuh): a
// TRANSPOSE_CONV's union conv over int8 codes q of a float input quantized
// per request (image n: zero point zp[n], scale[n]), int8 weights with no
// zero point and a float32 scale per column.  TFLite 2.21's hybrid
// TRANSPOSE_CONV (fault C9 in ROADMAP.md): an int32 sum of (q - zp) * w
// over the taps inside the image, then float32.  The kernel fills padded
// taps with the image's own zp (``fill``), so
//   a = acc - zp[n] * colsum[c]            (uint32: exact, |a| < 2^31)
// is that sum, padding included; then
//   v = float32(a) * (scale[n] * w_scale[c])   (__int2float_rn, _rn products)
//   v = v + bias[c]                             (when there is a bias)
// one rounding a step, as the plain version's float32 steps in PyTorch.
struct HybridConvEpilogue {
  using Out = float;
  static constexpr int w_zp = 0;
  const float* bias;       // [Oc], or null
  const float* w_scale;    // [Oc]
  const int32_t* colsum;   // [Oc] column sums of the weights
  const float* zp;         // [N] integers in [-128, 127]
  const float* scale;      // [N]
  int izp;                 // the bound image's zero point
  float iscale;            // and scale

  struct Params {
    float bias, w_scale;
    int32_t colsum;
  };
  __device__ __forceinline__ Params params(int c) const {
    return Params{bias != nullptr ? bias[c] : 0.f, w_scale[c], colsum[c]};
  }
  __device__ __forceinline__ void bind(int n) {
    izp = __float2int_rn(zp[n]);
    iscale = scale[n];
  }
  __device__ __forceinline__ int fill(int) const { return izp; }

  __device__ __forceinline__ float apply(int32_t acc, int32_t,
                                         const Params& p) const {
    const int32_t a = static_cast<int32_t>(
        static_cast<uint32_t>(acc) -
        static_cast<uint32_t>(izp) * static_cast<uint32_t>(p.colsum));
    float v = __fmul_rn(__int2float_rn(a), __fmul_rn(iscale, p.w_scale));
    if (bias != nullptr) v = __fadd_rn(v, p.bias);
    return v;
  }
};

}  // namespace band
