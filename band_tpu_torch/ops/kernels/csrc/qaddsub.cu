// Bit-exact TFLite quantized ADD and SUB of two same-shape int8 or uint8
// operands.
//
// No Pallas kernel carried this on the TPU: band_tpu's ADD/SUB is a chain
// of XLA int64 ops (band_tpu/ops/lowerings.py), and the port's first form
// was the same chain as eager PyTorch ops (ops/kernels/addsub.py
// qaddsub_plain): about 30 launches an op, each reading and writing an
// int64 tensor eight times the size of the int8 data.  The function, for
// each element, in the integer arithmetic of that chain
// (band_tpu_torch/ops/quant.py multiply_by_quantized_multiplier):
//   s1  = mbqm((x1 - zp1) << left_shift, qm1, sh1)        int32
//   s2  = mbqm((x2 - zp2) << left_shift, qm2, sh2)        int32
//   raw = s1 + s2 (ADD) or s1 - s2 (SUB)                   int64
//   out = clamp(mbqm(raw, qmo, sho) + zpo, qmin, qmax), one byte stored
// with mbqm's int64 product, rounding term, shift and int32 wrap taken
// exactly as the chain takes them for the rounding passed in.
//
// What bounds it on the H100: bytes, 3 an element (two operand bytes read,
// one output byte written); MobileNetV2's ADD of a window of 32 at
// 56x56x24 is 7.2 MB, 2.2 us at 3.35 TB/s.  The design moves each byte
// once and never materialises an intermediate: a thread takes 16
// elements through one 16-byte load of each operand and one 16-byte
// store where all three pointers are 16-byte aligned (bytes one by one
// otherwise, and for the ragged tail), in a grid-stride loop.  s1 and s2
// depend on one input byte each, so each block first fills two 256-entry
// int32 tables in shared memory with them (the first chunk's loads are
// issued before, so the fill hides under their latency); an element then
// costs two table reads, the sum and the output mbqm, all in registers.
// Nothing is allocated and nothing synchronises with the host, so the
// kernel can be captured in a CUDA graph.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "requant.cuh"

namespace band {

constexpr int kAddSubThreads = 256;  // ops/kernels/addsub.py THREADS

// x * qm * 2^(shift - 31) of an int64 x, as quant.py's
// multiply_by_quantized_multiplier takes it (x not cut to int32 first):
//   single:     wrap32((x*qm + 2^(t-1)) >> t), t = 31 - shift in [1, 62],
//               the product and the sum wrapping in 64 bits as in torch;
//   double/ruy: x' = wrap32(x << max(shift, 0)), r = max(-shift, 0),
//               wrap32((x'*qm + 2^30 + [r>0]*2^(30+r)
//                      - [double and r>0 and x'*qm+2^30<0]*2^31) >> (31+r)).
template <int R>
__device__ __forceinline__ int32_t mbqm64(long long x, int32_t qm,
                                          int shift) {
  if (R == kSingle) {
    const int t = 31 - shift;
    const unsigned long long p =
        static_cast<unsigned long long>(x) *
            static_cast<unsigned long long>(static_cast<long long>(qm)) +
        (1ULL << (t - 1));
    return wrap32(static_cast<long long>(p) >> t);
  }
  const int left = shift > 0 ? shift : 0;
  const int right = shift < 0 ? -shift : 0;
  const int32_t shifted = static_cast<int32_t>(
      static_cast<uint32_t>(static_cast<unsigned long long>(x)) << left);
  const long long sum0 = static_cast<long long>(shifted) * qm + (1LL << 30);
  long long add = right > 0 ? (1LL << (30 + right)) : 0LL;
  if (R == kDouble && right > 0 && sum0 < 0) add -= (1LL << 31);
  return wrap32((sum0 + add) >> (31 + right));
}

struct AddSubParams {
  int in1_uint8, in2_uint8;
  int zp1, zp2;
  int32_t qm1, qm2, qmo;
  int sh1, sh2, sho;
  int left_shift;
  int sign;        // +1 ADD, -1 SUB
  int lo, hi;      // qmin - zpo, qmax - zpo: the clamp before the add
  int zpo;
};

// one input's rescaled term for the input byte b
template <int R>
__device__ __forceinline__ int32_t input_term(int b, int in_uint8, int zp,
                                              int32_t qm, int sh, int ls) {
  const int v = in_uint8 ? b : static_cast<int>(static_cast<int8_t>(b));
  const long long a = static_cast<long long>(v) - zp;
  return mbqm64<R>(
      static_cast<long long>(static_cast<unsigned long long>(a) << ls), qm,
      sh);
}

// the output byte of the two terms: clamp(mbqm(raw) + zpo, qmin, qmax) as
// clamp(mbqm(raw), qmin - zpo, qmax - zpo) + zpo, the same integer without
// a 64-bit add; the byte stored is its low 8 bits (int8 or uint8 alike)
template <int R>
__device__ __forceinline__ uint32_t out_byte(int32_t s1, int32_t s2,
                                             const AddSubParams& p) {
  const long long raw = p.sign > 0
                            ? static_cast<long long>(s1) + s2
                            : static_cast<long long>(s1) - s2;
  int32_t v = mbqm64<R>(raw, p.qmo, p.sho);
  v = v < p.lo ? p.lo : (v > p.hi ? p.hi : v);
  return static_cast<uint32_t>(v + p.zpo) & 0xFFu;
}

template <int R>
__device__ __forceinline__ uint32_t out_word(uint32_t a, uint32_t b,
                                             const int32_t* t1,
                                             const int32_t* t2,
                                             const AddSubParams& p) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w |= out_byte<R>(t1[(a >> (8 * k)) & 0xFFu], t2[(b >> (8 * k)) & 0xFFu],
                     p)
         << (8 * k);
  return w;
}

template <int R>
__global__ void __launch_bounds__(kAddSubThreads)
    qaddsub_kernel(const uint8_t* __restrict__ x1,
                   const uint8_t* __restrict__ x2, uint8_t* __restrict__ out,
                   long long n, AddSubParams p, int vec) {
  __shared__ int32_t t1[256];
  __shared__ int32_t t2[256];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long chunks = vec ? n / 16 : 0;
  const uint4* v1 = reinterpret_cast<const uint4*>(x1);
  const uint4* v2 = reinterpret_cast<const uint4*>(x2);
  uint4 a = make_uint4(0, 0, 0, 0), b = a;
  if (i < chunks) {
    a = v1[i];
    b = v2[i];
  }
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    t1[k] = input_term<R>(k, p.in1_uint8, p.zp1, p.qm1, p.sh1, p.left_shift);
    t2[k] = input_term<R>(k, p.in2_uint8, p.zp2, p.qm2, p.sh2, p.left_shift);
  }
  __syncthreads();
  for (long long c = i; c < chunks; c += stride) {
    if (c != i) {
      a = v1[c];
      b = v2[c];
    }
    uint4 o;
    o.x = out_word<R>(a.x, b.x, t1, t2, p);
    o.y = out_word<R>(a.y, b.y, t1, t2, p);
    o.z = out_word<R>(a.z, b.z, t1, t2, p);
    o.w = out_word<R>(a.w, b.w, t1, t2, p);
    reinterpret_cast<uint4*>(out)[c] = o;
  }
  // bytes one by one: every element without 16-byte alignment, else the
  // ragged tail past the last whole chunk
  for (long long e = 16 * chunks + i; e < n; e += stride)
    out[e] = static_cast<uint8_t>(out_byte<R>(t1[x1[e]], t2[x2[e]], p));
}

}  // namespace band

extern "C" int band_qaddsub(const void* x1, int in1_uint8, const void* x2,
                            int in2_uint8, void* out, long long n, int zp1,
                            int zp2, int zpo, int qm1, int sh1, int qm2,
                            int sh2, int qmo, int sho, int left_shift,
                            int sign, int qmin, int qmax, int rounding,
                            int vec, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const band::AddSubParams p{in1_uint8, in2_uint8, zp1, zp2, qm1, qm2, qmo,
                             sh1, sh2, sho, left_shift, sign, qmin - zpo,
                             qmax - zpo, zpo};
  const uint8_t* a = static_cast<const uint8_t*>(x1);
  const uint8_t* b = static_cast<const uint8_t*>(x2);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (rounding == band::kSingle)
    band::qaddsub_kernel<band::kSingle>
        <<<blocks, band::kAddSubThreads, 0, s>>>(a, b, o, n, p, vec);
  else if (rounding == band::kDouble)
    band::qaddsub_kernel<band::kDouble>
        <<<blocks, band::kAddSubThreads, 0, s>>>(a, b, o, n, p, vec);
  else
    band::qaddsub_kernel<band::kRuy>
        <<<blocks, band::kAddSubThreads, 0, s>>>(a, b, o, n, p, vec);
  return static_cast<int>(cudaGetLastError());
}
