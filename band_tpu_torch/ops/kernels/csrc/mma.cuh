// Tensor-core building blocks shared by the int8 GEMM (qmatmul.cu) and
// B2's mma branch (qconv_mma.cuh): cp.async copies into shared memory,
// the s8 x s8 -> s32 m16n8k32 MMA, and the 4x4 byte transpose that turns
// four K rows of four columns into each column's four K bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace band {

template <int V>
__device__ __forceinline__ void cp_async(uint8_t* dst, const int8_t* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? V : 0;  // 0 source bytes: the copy writes zeros
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(V), "r"(n)
                 : "memory");
  }
}

// c += a . b over one 16 x 8 x 32 step (s8 x s8 -> s32)
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w0..w3: four K rows of four columns each; o[j]: column j's four K bytes
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             uint32_t (&o)[4]) {
  const uint32_t l01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t h01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t l23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t h23 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(l01, l23, 0x5410);
  o[1] = __byte_perm(l01, l23, 0x7632);
  o[2] = __byte_perm(h01, h23, 0x5410);
  o[3] = __byte_perm(h01, h23, 0x7632);
}

}  // namespace band
