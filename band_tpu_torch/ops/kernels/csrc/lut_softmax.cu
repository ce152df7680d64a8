// Bit-exact TFLite int8/uint8 SOFTMAX over the last axis.
//
// No Pallas kernel carried this on the TPU: band_tpu/ops/quant.py:443
// lut_softmax runs it as XLA ops with a lax.scan for the row sum.  The
// port needs a kernel because exactness requires the row sum in float32
// taken strictly left to right, and neither PyTorch's CUDA cumsum (a
// parallel scan) nor its CPU cumsum (a double accumulator) gives that
// order.  The function: mx = max(x), e = table[255 - mx + x], the row sum
// of e added column by column with round-to-nearest adds,
// inv = 1 / (sum * out_scale), q = int(e * inv + 0.5) + out_zp, clamped.
// Only _rn intrinsics, so nvcc contracts nothing into an FMA.
//
// What bounds it on the H100.  A few KB per call, so not the bytes: the
// serial float32 sum is a chain of `depth` dependent adds (~4 cycles
// each, ~2 us for MobileNetV2's 1000 classes at ~1.98 GHz), on top of
// the launch.  The first port ran one thread per row, which also made
// the max, the table reads and the output pass serial: three walks of
// 1000 dependent global loads, 50 us.
//
// The design.  Two kernels; softmax.py softmax_plan picks one by depth.
//  - The row kernel, for long rows: one block per row.  The threads
//    stage the row in shared memory (16-byte loads where a whole aligned
//    chunk lies in the row, bytes at its ragged ends) and the table, take
//    the integer max with warp shuffles and one cross-warp step (its
//    order does not matter), and write the row's e values to shared
//    memory in parallel, 4 per thread.  Then ONE thread adds them left to
//    right, its
//    shared-memory loads issued a step ahead of the dependent add chain
//    (16 values, four 16-byte loads, per step): without that each step
//    waited on its loads, ~8 cycles per element instead of one add's ~4.
//    After one barrier every thread computes and stores output bytes, 4
//    at a time into each aligned word of the output row.  (Chunks of 16
//    output bytes per thread left 3/4 of the threads idle and read e with
//    16-way bank conflicts: ~1 us of the 1000-class row, PERF.md.)
//  - The thread kernel, for short rows (TFLite's [1, 10] classifiers,
//    quant_act_int8's rows of 8): one thread walks one row, as the first
//    port did; a block's barriers cost more than such a row's work.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace band {

constexpr int kRowMaxThreads = 256;  // the row kernel's launch bound

__device__ __forceinline__ int value_of(uint8_t b, int in_uint8) {
  return in_uint8 ? static_cast<int>(b)
                  : static_cast<int>(static_cast<int8_t>(b));
}

// the output byte of one element: clamp(int(e * inv + 0.5) + out_zp)
__device__ __forceinline__ uint8_t quantize(float e, float inv, int out_zp,
                                            int qmin, int qmax) {
  int q = static_cast<int>(__fadd_rn(__fmul_rn(e, inv), 0.5f)) + out_zp;
  q = q < qmin ? qmin : (q > qmax ? qmax : q);
  return static_cast<uint8_t>(q);
}

// ---------------------------------------------------------------------------
// the thread kernel: one thread per row
// ---------------------------------------------------------------------------

__global__ void lut_softmax_kernel(const uint8_t* __restrict__ x,
                                   int in_uint8,
                                   const float* __restrict__ table,
                                   uint8_t* __restrict__ out, int rows,
                                   int depth, float out_scale, int out_zp,
                                   int qmin, int qmax) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* xr = x + static_cast<size_t>(r) * depth;
  uint8_t* orow = out + static_cast<size_t>(r) * depth;
  int mx = value_of(xr[0], in_uint8);
  for (int i = 1; i < depth; ++i) mx = max(mx, value_of(xr[i], in_uint8));
  float s = 0.0f;
  for (int i = 0; i < depth; ++i)
    s = __fadd_rn(s, table[255 - mx + value_of(xr[i], in_uint8)]);
  const float inv = __fdiv_rn(1.0f, __fmul_rn(s, out_scale));
  for (int i = 0; i < depth; ++i)
    orow[i] = quantize(table[255 - mx + value_of(xr[i], in_uint8)], inv,
                       out_zp, qmin, qmax);
}

// ---------------------------------------------------------------------------
// the row kernel: one block per row
// ---------------------------------------------------------------------------

// Shared memory of the row kernel (dynamic): the table (256 floats), the
// e values (depth floats, rounded up to 16), then the staged row bytes,
// placed at the row's own offset in its 16-byte chunk (x_off) so that
// each aligned chunk of the row lands on an aligned chunk of the buffer.
__host__ __device__ inline int row_e_floats(int depth) {
  return (depth + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kRowMaxThreads)
    lut_softmax_row_kernel(const uint8_t* __restrict__ x, int in_uint8,
                           const float* __restrict__ table,
                           uint8_t* __restrict__ out, int depth,
                           float out_scale, int out_zp, int qmin, int qmax) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_max[kRowMaxThreads / 32];
  __shared__ float s_inv;
  float* s_table = smem;
  float* s_e = smem + 256;
  uint8_t* s_x = reinterpret_cast<uint8_t*>(s_e + row_e_floats(depth));

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint8_t* xr = x + static_cast<size_t>(blockIdx.x) * depth;
  uint8_t* orow = out + static_cast<size_t>(blockIdx.x) * depth;

  // 1. stage the table and the row (the table's loads issued first, its
  // stores after the row's loads); each thread's max of what it loaded
  float tv[256 / 32];
#pragma unroll
  for (int k = 0; k < 256 / 32; ++k)
    if (tid + k * nt < 256) tv[k] = table[tid + k * nt];
  const int x_off = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15);
  const uint8_t* xa = xr - x_off;  // the row's first aligned chunk
  const int chunks = (x_off + depth + 15) / 16;
  int mx = -256;
  for (int j = tid; j < chunks; j += nt) {
    const int lo = 16 * j - x_off;  // element index of the chunk's byte 0
    if (lo >= 0 && lo + 16 <= depth) {
      const uint4 v = *reinterpret_cast<const uint4*>(xa + 16 * j);
      *reinterpret_cast<uint4*>(s_x + 16 * j) = v;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        mx = max(mx, value_of(static_cast<uint8_t>(w[b / 4] >> (8 * (b % 4))),
                              in_uint8));
    } else {
      // a chunk at a ragged end: its bytes' loads all issued, then used
      uint8_t v[16];
#pragma unroll
      for (int b = 0; b < 16; ++b)
        v[b] = lo + b >= 0 && lo + b < depth ? xr[lo + b] : 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (lo + b < 0 || lo + b >= depth) continue;
        s_x[16 * j + b] = v[b];
        mx = max(mx, value_of(v[b], in_uint8));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 256 / 32; ++k)
    if (tid + k * nt < 256) s_table[tid + k * nt] = tv[k];
  // 2. the row's max: warp shuffles, then one value per warp
#pragma unroll
  for (int d = 16; d > 0; d /= 2) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  if (tid % 32 == 0) s_max[tid / 32] = mx;
  __syncthreads();
  mx = s_max[0];
  for (int k = 1; k < nt / 32; ++k) mx = max(mx, s_max[k]);
  // 3. e = table[255 - max + x], in parallel, 4 elements (one 16-byte
  // store) per thread and step; zeros past depth up to a multiple of 16
  for (int i = 4 * tid; i < row_e_floats(depth); i += 4 * nt) {
    float e[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      e[b] = i + b < depth
                 ? s_table[255 - mx + value_of(s_x[x_off + i + b], in_uint8)]
                 : 0.0f;
    *reinterpret_cast<float4*>(s_e + i) = make_float4(e[0], e[1], e[2], e[3]);
  }
  __syncthreads();
  // 4. one thread adds the e values left to right, 16 at a time, the
  // next 16 loaded (four 16-byte loads) before the current 16 are added.
  // The zeros that pad the last 16 change nothing: s + 0.0f == s for the
  // sum of positive table values.
  if (tid == 0) {
    float s = 0.0f;
    const float4* e4 = reinterpret_cast<const float4*>(s_e);
    const int blocks = row_e_floats(depth) / 16;
    float4 a, b, c, d;
    if (blocks > 0) {
      a = e4[0]; b = e4[1]; c = e4[2]; d = e4[3];
    }
    for (int k = 0; k < blocks; ++k) {
      float4 na = a, nb = b, nc = c, nd = d;
      if (k + 1 < blocks) {
        na = e4[4 * k + 4]; nb = e4[4 * k + 5];
        nc = e4[4 * k + 6]; nd = e4[4 * k + 7];
      }
      s = __fadd_rn(s, a.x); s = __fadd_rn(s, a.y);
      s = __fadd_rn(s, a.z); s = __fadd_rn(s, a.w);
      s = __fadd_rn(s, b.x); s = __fadd_rn(s, b.y);
      s = __fadd_rn(s, b.z); s = __fadd_rn(s, b.w);
      s = __fadd_rn(s, c.x); s = __fadd_rn(s, c.y);
      s = __fadd_rn(s, c.z); s = __fadd_rn(s, c.w);
      s = __fadd_rn(s, d.x); s = __fadd_rn(s, d.y);
      s = __fadd_rn(s, d.z); s = __fadd_rn(s, d.w);
      a = na; b = nb; c = nc; d = nd;
    }
    s_inv = __fdiv_rn(1.0f, __fmul_rn(s, out_scale));
  }
  __syncthreads();
  // 5. the output bytes, one aligned 4-byte word of the output row per
  // thread and step (bytes at its ragged ends); a row that starts on a
  // word reads its 4 e values with one 16-byte load
  const float inv = s_inv;
  const int o_off = static_cast<int>(reinterpret_cast<uintptr_t>(orow) & 3);
  uint8_t* oa = orow - o_off;
  const int owords = (o_off + depth + 3) / 4;
  for (int j = tid; j < owords; j += nt) {
    const int lo = 4 * j - o_off;
    if (lo >= 0 && lo + 4 <= depth) {
      float e[4];
      if (o_off == 0) {
        const float4 v = *reinterpret_cast<const float4*>(s_e + lo);
        e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) e[b] = s_e[lo + b];
      }
      uint32_t w = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w |= static_cast<uint32_t>(quantize(e[b], inv, out_zp, qmin, qmax))
             << (8 * b);
      *reinterpret_cast<uint32_t*>(oa + 4 * j) = w;
    } else {
      for (int b = 0; b < 4; ++b) {
        const int i = lo + b;
        if (i >= 0 && i < depth)
          orow[i] = quantize(s_e[i], inv, out_zp, qmin, qmax);
      }
    }
  }
}

}  // namespace band

// branch 0: the thread kernel, `threads` rows to a block; branch 1: the
// row kernel, one block of `threads` threads per row with `smem` bytes of
// dynamic shared memory (softmax.py softmax_plan)
extern "C" int band_lut_softmax(const void* x, int in_uint8,
                                const void* table, void* out, int rows,
                                int depth, float out_scale, int out_zp,
                                int qmin, int qmax, int branch, int threads,
                                int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* px = static_cast<const uint8_t*>(x);
  const float* pt = static_cast<const float*>(table);
  uint8_t* po = static_cast<uint8_t*>(out);
  if (branch == 0) {
    band::lut_softmax_kernel<<<(rows + threads - 1) / threads, threads, 0, s>>>(
        px, in_uint8, pt, po, rows, depth, out_scale, out_zp, qmin, qmax);
  } else {
    band::lut_softmax_row_kernel<<<rows, threads, smem, s>>>(
        px, in_uint8, pt, po, depth, out_scale, out_zp, qmin, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}
