// Bit-exact TFLite int8/uint8 SOFTMAX over the last axis.
//
// No Pallas kernel carried this on the TPU: band_tpu/ops/quant.py:443
// lut_softmax runs it as XLA ops with a lax.scan for the row sum.  The
// port needs a kernel because exactness requires the row sum in float32
// taken strictly left to right, and neither PyTorch's CUDA cumsum (a
// parallel scan) nor its CPU cumsum (a double accumulator) gives that
// order.  One thread walks one row: max, sum of table[255 - max + x] with
// round-to-nearest adds (no FMA contraction), then
// q = int(e * (1 / (sum * out_scale)) + 0.5) + out_zp, clamped.
// Bound on this card: a few KB per call, so launch latency bounds it.
#include <cuda_runtime.h>

#include <cstdint>

namespace band {

__global__ void lut_softmax_kernel(const uint8_t* __restrict__ x,
                                   int in_uint8,
                                   const float* __restrict__ table,
                                   int8_t* __restrict__ out, int rows,
                                   int depth, float out_scale, int out_zp,
                                   int qmin, int qmax) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* xr = x + static_cast<size_t>(r) * depth;
  int8_t* orow = out + static_cast<size_t>(r) * depth;
  auto value = [&](int i) -> int {
    return in_uint8 ? static_cast<int>(xr[i])
                    : static_cast<int>(static_cast<int8_t>(xr[i]));
  };
  int mx = value(0);
  for (int i = 1; i < depth; ++i) mx = max(mx, value(i));
  float s = 0.0f;
  for (int i = 0; i < depth; ++i) s = __fadd_rn(s, table[255 - mx + value(i)]);
  const float inv = __fdiv_rn(1.0f, __fmul_rn(s, out_scale));
  for (int i = 0; i < depth; ++i) {
    const float prob = __fmul_rn(table[255 - mx + value(i)], inv);
    int q = static_cast<int>(__fadd_rn(prob, 0.5f)) + out_zp;
    q = q < qmin ? qmin : (q > qmax ? qmax : q);
    orow[i] = static_cast<int8_t>(static_cast<uint8_t>(q));
  }
}

}  // namespace band

extern "C" int band_lut_softmax(const void* x, int in_uint8,
                                const void* table, void* out, int rows,
                                int depth, float out_scale, int out_zp,
                                int qmin, int qmax, void* stream) {
  const int threads = 64;
  const int blocks = (rows + threads - 1) / threads;
  band::lut_softmax_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), in_uint8,
      static_cast<const float*>(table), static_cast<int8_t*>(out), rows,
      depth, out_scale, out_zp, qmin, qmax);
  return static_cast<int>(cudaGetLastError());
}
