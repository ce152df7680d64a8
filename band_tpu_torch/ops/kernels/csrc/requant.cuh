// Bit-exact TFLite requantization epilogue shared by the int8 kernels.
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
  const int32_t* bias;
  const int32_t* qm;
  const int32_t* shift;
  int qstride;
  int w_zp;
  int out_zp;
  int qmin;
  int qmax;
  int rounding;

  // acc: the raw s8 x s8 sum; wsum: the window (row) sum of the input,
  // which the weight zero point multiplies.  Returns the output byte.
  __device__ __forceinline__ int8_t operator()(int32_t acc, int32_t wsum,
                                               int c) const {
    const uint32_t a = static_cast<uint32_t>(acc) -
                       static_cast<uint32_t>(w_zp) * static_cast<uint32_t>(wsum) +
                       static_cast<uint32_t>(bias[c]);
    const int32_t q = requantize(static_cast<int32_t>(a), qm[c * qstride],
                                 shift[c * qstride], out_zp, qmin, qmax,
                                 rounding);
    return static_cast<int8_t>(static_cast<uint8_t>(q));
  }
};

}  // namespace band
