// Int8 NHWC convolution as an implicit GEMM with a fused requant
// epilogue: the exact TFLite requant (kernel B2) and, as a template
// instance of the same source, the float32 requant of fast numerics.
//
// Replaces band_tpu/ops/pallas/qconv.py:152 qconv2d_exact (kernel body
// _qconv_kernel :93, pallas_call at :207).  The TPU kernel took a
// zero-point-padded input at stride 1 and dilation 1 and sat off the
// serving path (XLA's conv carried dense convs); here it carries every
// CONV_2D that is not a 1x1 stride-1 matmul, so it adds stride, dilation
// and padding: taps outside the image read x_zp, with no padded copy.
// Columns k = (dy, dx, ci) match the weight layout [kh*kw*Ci, Oc].
//
// The fast instance (band_qconv2d_fast) replaces what band_tpu's fast path
// ran for such convs: XLA's conv followed by requantize_fast
// (band_tpu/ops/lowerings.py:563-575, band_tpu/ops/quant.py:344).  It
// computes that function with the FastEpilogue of requant.cuh.
//
// Bound on this card: MobileNetV2's only such conv is the stem
// (224^2 x 3 -> 112^2 x 32, 3x3 s2, K = 27), ~11 MOPs over ~0.55 MB, so
// memory and the gather of the 3-channel taps bound it.
#include <cuda_runtime.h>

#include <cstdint>

#include "qgemm.cuh"

namespace band {

template <class Ep>
int launch_qconv(const void* x, const void* w, void* out, int n, int h,
                 int wd, int ci, int oh, int ow, int oc, int kh, int kw,
                 int sh, int sw, int dh, int dw, int pt, int pl, int x_zp,
                 const Ep& ep, void* stream) {
  const int M = n * oh * ow;
  const int K = kh * kw * ci;
  const dim3 grid((oc + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* px = static_cast<const int8_t*>(x);
  const int8_t* pw = static_cast<const int8_t*>(w);
  int8_t* po = static_cast<int8_t*>(out);
  if (ci % 4 == 0 && reinterpret_cast<uintptr_t>(px) % 4 == 0) {
    const Im2colA<true> A{px, h, wd, ci, oh, ow, kw, sh, sw, dh, dw, pt, pl,
                          K, x_zp};
    qgemm_kernel<Im2colA<true>, Ep><<<grid, kGemmThreads, 0, s>>>(
        A, pw, po, M, oc, K, ep);
  } else {
    const Im2colA<false> A{px, h, wd, ci, oh, ow, kw, sh, sw, dh, dw, pt, pl,
                           K, x_zp};
    qgemm_kernel<Im2colA<false>, Ep><<<grid, kGemmThreads, 0, s>>>(
        A, pw, po, M, oc, K, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band

extern "C" int band_qconv2d_exact(
    const void* x, const void* w, const void* bias, const void* qm,
    const void* shift, void* out, int n, int h, int wd, int ci, int oh,
    int ow, int oc, int kh, int kw, int sh, int sw, int dh, int dw, int pt,
    int pl, int qstride, int x_zp, int w_zp, int out_zp, int qmin, int qmax,
    int rounding, void* stream) {
  using namespace band;
  const Epilogue ep{static_cast<const int32_t*>(bias),
                    static_cast<const int32_t*>(qm),
                    static_cast<const int32_t*>(shift),
                    qstride, w_zp, out_zp, qmin, qmax, rounding};
  return launch_qconv(x, w, out, n, h, wd, ci, oh, ow, oc, kh, kw, sh, sw, dh,
                      dw, pt, pl, x_zp, ep, stream);
}

extern "C" int band_qconv2d_fast(
    const void* x, const void* w, const void* bias, const void* mult,
    void* out, int n, int h, int wd, int ci, int oh, int ow, int oc, int kh,
    int kw, int sh, int sw, int dh, int dw, int pt, int pl, int mstride,
    int x_zp, int w_zp, int out_zp, int qmin, int qmax, void* stream) {
  using namespace band;
  const FastEpilogue ep{static_cast<const int32_t*>(bias),
                        static_cast<const float*>(mult), mstride, w_zp,
                        out_zp, qmin, qmax};
  return launch_qconv(x, w, out, n, h, wd, ci, oh, ow, oc, kh, kw, sh, sw, dh,
                      dw, pt, pl, x_zp, ep, stream);
}
