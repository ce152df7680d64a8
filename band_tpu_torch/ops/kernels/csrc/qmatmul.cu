// Exact int8 matmul with the fused TFLite requant (kernel B1).
//
// Replaces band_tpu/ops/pallas/qmatmul.py:135 qmatmul_exact (kernel body
// _qmatmul_exact_kernel, pallas_call at :165): every FULLY_CONNECTED and
// every 1x1 stride-1 CONV_2D.  out[M, N] = requant(A . B - w_zp * rowsum(A)
// + bias) with A [M, K] int8, B [K, N] int8, bias/qm/shift int32.
// Bound on this card: at MobileNetV2's b1 shapes (K and N of 16..1280,
// M of 49..12544) the work is ~0.1-50 MOPs against a few hundred KB, so
// memory and launch latency bound it, not the tensor cores; the tile
// loop reads each A tile once per 64 output columns.
#include <cuda_runtime.h>

#include <cstdint>

#include "qgemm.cuh"

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
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int8_t* po = static_cast<int8_t*>(out);
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(pa) % 4 == 0) {
    qgemm_kernel<DenseA<true>><<<grid, kGemmThreads, 0, s>>>(
        DenseA<true>{pa, K}, pb, po, M, N, K, ep);
  } else {
    qgemm_kernel<DenseA<false>><<<grid, kGemmThreads, 0, s>>>(
        DenseA<false>{pa, K}, pb, po, M, N, K, ep);
  }
  return static_cast<int>(cudaGetLastError());
}
