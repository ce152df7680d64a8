// Exact int8 depthwise convolution with the fused TFLite requant
// (kernel B3).
//
// Replaces band_tpu/ops/pallas/qdwconv.py:114 qdwconv2d_exact (kernel body
// _qdwconv_kernel :81, pallas_call at :188).  The TPU kernel split strided
// inputs into phase planes and banded rows to fill its 128-lane vector
// unit; none of that carries over.  Here one thread computes one output
// element over its kh x kw taps, channels fastest so that a warp reads
// and writes consecutive bytes.  It also takes a depth multiplier
// (output channel c reads input channel c / mult) and dilation, and reads
// x_zp for taps in the padding instead of a padded copy.
// Bound on this card: 9 MACs per output byte, so memory (each input byte
// is read by up to kh*kw neighbouring threads, mostly from L1/L2).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "requant.cuh"

namespace band {

__global__ void qdwconv_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ w,
                               int8_t* __restrict__ out, int total, int h,
                               int wd, int ci, int mult, int oh, int ow,
                               int kh, int kw, int sh, int sw, int dh, int dw,
                               int pt, int pl, int x_zp, Epilogue ep) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = ci * mult;
  const int c = idx % co;
  int r = idx / co;
  const int oxw = r % ow;
  r /= ow;
  const int oyh = r % oh;
  const int n = r / oh;
  const int cin = c / mult;
  const int8_t* img = x + static_cast<size_t>(n) * h * wd * ci + cin;
  const int ih0 = oyh * sh - pt;
  const int iw0 = oxw * sw - pl;
  int32_t acc = 0;
  int32_t rs = 0;
  for (int dy = 0; dy < kh; ++dy) {
    const int ih = ih0 + dy * dh;
    const bool row_in = ih >= 0 && ih < h;
    for (int dx = 0; dx < kw; ++dx) {
      const int iw = iw0 + dx * dw;
      const int32_t v = (row_in && iw >= 0 && iw < wd)
                            ? img[(static_cast<size_t>(ih) * wd + iw) * ci]
                            : x_zp;
      acc += v * static_cast<int32_t>(w[(dy * kw + dx) * co + c]);
      rs += v;
    }
  }
  out[idx] = ep(acc, rs, c);
}

}  // namespace band

extern "C" int band_qdwconv2d_exact(
    const void* x, const void* w, const void* bias, const void* qm,
    const void* shift, void* out, int n, int h, int wd, int ci, int mult,
    int oh, int ow, int kh, int kw, int sh, int sw, int dh, int dw, int pt,
    int pl, int qstride, int x_zp, int w_zp, int out_zp, int qmin, int qmax,
    int rounding, void* stream) {
  using namespace band;
  const Epilogue ep{static_cast<const int32_t*>(bias),
                    static_cast<const int32_t*>(qm),
                    static_cast<const int32_t*>(shift),
                    qstride, w_zp, out_zp, qmin, qmax, rounding};
  const int total = n * oh * ow * ci * mult;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  qdwconv_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int8_t*>(out), total, h, wd, ci, mult, oh, ow, kh, kw, sh,
      sw, dh, dw, pt, pl, x_zp, ep);
  return static_cast<int>(cudaGetLastError());
}
