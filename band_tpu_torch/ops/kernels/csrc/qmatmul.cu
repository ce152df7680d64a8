// Int8 matmul with a fused requant epilogue: the exact TFLite requant
// (kernel B1) and the float32 requant of fast numerics (kernel B4).
//
// B1 replaces band_tpu/ops/pallas/qmatmul.py:135 qmatmul_exact (kernel body
// _qmatmul_exact_kernel, pallas_call at :165): every FULLY_CONNECTED and
// every 1x1 stride-1 CONV_2D.  out[M, N] = requant(A . B - w_zp * rowsum(A)
// + bias) with A [M, K] int8, B [K, N] int8, bias/qm/shift int32.
//
// B4 replaces band_tpu/ops/pallas/qmatmul.py:42 qmatmul (kernel body
// _qmatmul_kernel :26-36, pallas_call at :65): the same product with
// clamp(round_half_even(float32(A . B - w_zp * rowsum(A) + bias) * mult)
// + out_zp), mult float32 per channel or per tensor.  It computes that
// function, not the Pallas blocks: the TPU kernel took M and N in tiles
// of 256 with the whole K resident and had no w_zp term; this one takes
// any shape, the weight zero point of uint8-era models (band_tpu's fast
// FC subtracts w_zp * rowsum before the bias, lowerings.py:1079-1083) and
// uint8 outputs.  On the card it carries every fast FULLY_CONNECTED and
// every fast 1x1 stride-1 CONV_2D.
//
// Both share the tile loop of qgemm.cuh (64 x 64 __dp4a tiles).  Bound on
// this card: at MobileNetV2's b1 shapes (K and N of 16..1280, M of
// 1..12544) the work is ~0.1-50 MOPs against a few hundred KB, so memory
// and launch latency bound it, not the tensor cores; the tile loop reads
// each A tile once per 64 output columns.
#include <cuda_runtime.h>

#include <cstdint>

#include "qgemm.cuh"

namespace band {

template <class Ep>
int launch_qmatmul(const void* a, const void* b, void* out, int M, int N,
                   int K, const Ep& ep, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int8_t* po = static_cast<int8_t*>(out);
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(pa) % 4 == 0) {
    qgemm_kernel<DenseA<true>, Ep><<<grid, kGemmThreads, 0, s>>>(
        DenseA<true>{pa, K}, pb, po, M, N, K, ep);
  } else {
    qgemm_kernel<DenseA<false>, Ep><<<grid, kGemmThreads, 0, s>>>(
        DenseA<false>{pa, K}, pb, po, M, N, K, ep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band

extern "C" int band_qmatmul_exact(const void* a, const void* b,
                                  const void* bias, const void* qm,
                                  const void* shift, void* out, int M, int N,
                                  int K, int qstride, int w_zp, int out_zp,
                                  int qmin, int qmax, int rounding,
                                  void* stream) {
  using namespace band;
  const Epilogue ep{static_cast<const int32_t*>(bias),
                    static_cast<const int32_t*>(qm),
                    static_cast<const int32_t*>(shift),
                    qstride, w_zp, out_zp, qmin, qmax, rounding};
  return launch_qmatmul(a, b, out, M, N, K, ep, stream);
}

extern "C" int band_qmatmul_fast(const void* a, const void* b,
                                 const void* bias, const void* mult,
                                 void* out, int M, int N, int K, int mstride,
                                 int w_zp, int out_zp, int qmin, int qmax,
                                 void* stream) {
  using namespace band;
  const FastEpilogue ep{static_cast<const int32_t*>(bias),
                        static_cast<const float*>(mult), mstride, w_zp,
                        out_zp, qmin, qmax};
  return launch_qmatmul(a, b, out, M, N, K, ep, stream);
}
