// Tiled s8 x s8 -> s32 GEMM main loop with a fused requant epilogue
// (exact or fast, requant.cuh) for the implicit-GEMM conv (qconv.cu): the A
// operand is the im2col window of an NHWC image, read straight from the
// unpadded input.  (The int8 matmul has its own tensor-core kernel,
// qmatmul.cu.)
//
// Design (simple and right first; wgmma/TMA are later work): one block
// computes a 64 x 64 output tile with 256 threads, each a 4 x 4
// micro-tile.  K advances 32 bytes at a time through shared memory,
// stored as 32-bit words so that one __dp4a multiplies four int8 pairs.
// B is [K, N] row-major (the prepared weight layout) and is transposed
// into shared memory per tile.  The row sums that the weight zero point
// multiplies come from the same A words (__dp4a against 0x01010101).
#pragma once

#include <cstddef>
#include <cstdint>

#include "requant.cuh"

namespace band {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kBKW = kBK / 4;  // 32-bit words per tile row
constexpr int kGemmThreads = 256;

__device__ __forceinline__ uint32_t byte_at(int8_t v, int e) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * e);
}

// A = the im2col matrix of an NHWC int8 image: row m = (n, oh, ow), column
// k = (dy, dx, ci) in that order (the weight layout [kh*kw*Ci, Oc]).  Taps
// that fall in the padding read x_zp.  kVec: Ci % 4 == 0 and the base is
// 4-byte aligned, so a 4-byte group never straddles two taps.
template <bool kVec>
struct Im2colA {
  const int8_t* x;
  int H, W, Ci, OH, OW, kw, sh, sw, dh, dw, pt, pl, K;
  int x_zp;

  struct Row {
    const int8_t* img;  // nullptr past the last row
    int ih0, iw0;
  };

  __device__ __forceinline__ Row row(int m, int M) const {
    if (m >= M) return Row{nullptr, 0, 0};
    const int hw = OH * OW;
    const int n = m / hw;
    const int r = m - n * hw;
    const int oh = r / OW;
    const int ow = r - oh * OW;
    return Row{x + static_cast<size_t>(n) * H * W * Ci, oh * sh - pt,
               ow * sw - pl};
  }

  __device__ __forceinline__ const int8_t* tap(const Row& r, int k,
                                               int* ci) const {
    const int t = k / Ci;
    *ci = k - t * Ci;
    const int dy = t / kw;
    const int dx = t - dy * kw;
    const int ih = r.ih0 + dy * dh;
    const int iw = r.iw0 + dx * dw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return r.img + (static_cast<size_t>(ih) * W + iw) * Ci;
  }

  __device__ __forceinline__ uint32_t load(const Row& r, int k) const {
    if (r.img == nullptr) return 0u;
    if (kVec) {
      if (k >= K) return 0u;
      int ci;
      const int8_t* p = tap(r, k, &ci);
      if (p == nullptr)
        return static_cast<uint32_t>(static_cast<uint8_t>(x_zp)) * 0x01010101u;
      return *reinterpret_cast<const uint32_t*>(p + ci);
    }
    uint32_t v = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e >= K) break;
      int ci;
      const int8_t* p = tap(r, k + e, &ci);
      v |= byte_at(p == nullptr ? static_cast<int8_t>(x_zp) : p[ci], e);
    }
    return v;
  }
};

// out[M, N] = ep(A[M, K] . B[K, N], rowsum(A)): the requant of
// A . B - w_zp * rowsum(A) + bias by the exact Epilogue or FastEpilogue
template <class ALoader, class Ep>
__global__ void __launch_bounds__(kGemmThreads)
    qgemm_kernel(ALoader A, const int8_t* __restrict__ B,
                 int8_t* __restrict__ out, int M, int N, int K, Ep ep) {
  __shared__ uint32_t As[kBM][kBKW + 1];
  __shared__ uint32_t Bs[kBN][kBKW + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // row tiles on grid x (up to 2^31 - 1 blocks: a b32 window of 360x640
  // outputs has 115,200), column tiles on y (at most 65,535)
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A tile loads: word w = tid + 256 q is row w / 8, word column w % 8
  const int a_kw = tid % kBKW;
  const int a_row = tid / kBKW;  // 0..31, second word at +32
  const typename ALoader::Row arow0 = A.row(m0 + a_row, M);
  const typename ALoader::Row arow1 = A.row(m0 + a_row + 32, M);
  // B tile loads: word w = tid + 256 q is column w % 64, word row w / 64
  const int b_n = tid % kBN;
  const int b_kw = tid / kBN;  // 0..3, second word at +4
  const int bn = n0 + b_n;

  int32_t acc[4][4];
  int32_t rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rs[i] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    As[a_row][a_kw] = A.load(arow0, k0 + 4 * a_kw);
    As[a_row + 32][a_kw] = A.load(arow1, k0 + 4 * a_kw);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int kw = b_kw + 4 * q;
      const int k = k0 + 4 * kw;
      uint32_t v = 0u;
      if (bn < N) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) v |= byte_at(B[static_cast<size_t>(k + e) * N + bn], e);
      }
      Bs[b_n][kw] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = static_cast<int>(As[ty + 16 * i][kw]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = static_cast<int>(Bs[tx + 16 * j][kw]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      if (ep.w_zp != 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rs[i] = __dp4a(a[i], 0x01010101, rs[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = ep(acc[i][j], rs[i], n);
    }
  }
}

}  // namespace band
