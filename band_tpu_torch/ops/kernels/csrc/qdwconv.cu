// Int8 depthwise convolution with a fused requant epilogue: the exact
// TFLite requant (kernel B3) and, as a template instance of the same
// source, the float32 requant of fast numerics.
//
// Replaces band_tpu/ops/pallas/qdwconv.py:114 qdwconv2d_exact (kernel body
// _qdwconv_kernel :81, pallas_call at :188).  The TPU kernel split strided
// inputs into phase planes and banded rows to fill its 128-lane vector
// unit; none of that carries over.  It computes that function, and also
// takes a depth multiplier (output channel c reads input channel c / mult),
// dilation, sh != sw, uint8 outputs, a weight zero point, and padding read
// as x_zp instead of a padded copy.
//
// The fast instance (band_qdwconv2d_fast) replaces what band_tpu's fast
// path ran for depthwise convs: XLA's grouped conv followed by
// requantize_fast (band_tpu/ops/lowerings.py:943-964,
// band_tpu/ops/quant.py:344).  It computes that function with the
// FastEpilogue of requant.cuh.
//
// What bounds it on the H100.  MobileNetV2's 17 depthwise convs at batch 1
// move 0.09-1.5 MB each (0.03-0.45 us at 3.35 TB/s) and do 9 MACs per
// output byte, so neither the memory nor the ALUs set the time: launch and
// latency do, i.e. how many dependent round trips to memory a thread makes
// and how many instructions it then issues alone.  The first port (one
// thread per output byte, now the general branch below) spent 5.5 us a
// call on index division, 9 single-byte input loads, 9 weight loads and
// three epilogue loads per output byte, and its own int64 requant.
//
// The design (the strip kernel):
//  1. A vector of channels.  NHWC keeps channels contiguous: a thread owns
//     kVec = 4 consecutive channels and reads each pixel's with one 32-bit
//     load.  Its kh*kw tap weights and its channels' epilogue parameters
//     are loaded once, into registers (Epilogue::Params /
//     FastEpilogue::Params).  Vectors of 8 and 16 channels were measured
//     and lost on every MobileNetV2 shape but a few at batch 8: fewer,
//     longer threads (PERF.md).
//  2. A strip of R output columns.  The thread loads its kh input rows'
//     (R-1)*sw + kw columns once, all before the first multiply, and each
//     column serves every output of the strip whose window covers it: for
//     3x3 at stride 1 that is 3*(R+2)/R loads per output pixel, not 9.
//  3. The multiply-accumulate on int8 lanes with __dp4a.  For each channel
//     and input column the kh rows' bytes are gathered into one word (two
//     for 5x5) with __byte_perm, and the weights of each horizontal tap the
//     same way, once per thread with the bytes past kh zeroed.  One dp4a
//     then sums a whole vertical tap column: 3 dp4a per output byte for
//     3x3, and about 2*(R+2)/R byte permutes.  (Sign-extending each byte
//     and multiply-adding in int32 instead was 4-18% slower, PERF.md.)
//  4. No per-thread division: the grid is (channel groups, column strips,
//     batch * output rows) on blockIdx.{x,y,z}, and the window sum that
//     w_zp multiplies is a template flag (WZP), computed only when
//     w_zp != 0.
//  5. The plan (qdwconv.py dwconv_plan) picks the variant (kh, sw, R) and
//     the block per shape and passes grid and block through ctypes.
//     Geometries the strip kernel does not take (a C or a base address of
//     x, w or out that is not a multiple of 4, depth multiplier > 1,
//     dilation > 1, kernels other than 3x3 and 5x5, horizontal stride > 2)
//     take the general branch: one thread per output byte, the first
//     port's loop.
//
// Exactness.  dp4a sums int8 products into int32; a 3x3 or 5x5 window sum
// is at most 25 * 128 * 128 < 2^31, and the bias and w_zp terms are added
// in uint32 in the epilogue, as in the plain version (the int32 wrap of an
// exact sum).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "requant.cuh"

namespace band {

constexpr int kMaxThreads = 256;  // block size bound of every variant
constexpr int kVec = 4;           // channels of a strip thread

// ---------------------------------------------------------------------------
// the general branch: one thread per output byte
// ---------------------------------------------------------------------------

template <class Ep>
__global__ void qdwconv_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ w,
                               int8_t* __restrict__ out, int total, int h,
                               int wd, int ci, int mult, int oh, int ow,
                               int kh, int kw, int sh, int sw, int dh, int dw,
                               int pt, int pl, int x_zp, Ep ep) {
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

// ---------------------------------------------------------------------------
// the strip kernel
// ---------------------------------------------------------------------------

// one pixel's kVec channel bytes as a word
__device__ __forceinline__ uint32_t load_px(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Byte b of m row words (m = 1..4) gathered into one word, the first row
// in byte 0.  The bytes from m on are left as they fall.
__device__ __forceinline__ uint32_t gather(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3, int m,
                                           int b) {
  const uint32_t lo = __byte_perm(r0, r1, b | ((b + 4) << 4));
  if (m <= 2) return lo;
  if (m == 3) return __byte_perm(lo, r2, 0x0010 | ((b + 4) << 8));
  return __byte_perm(lo, __byte_perm(r2, r3, b | ((b + 4) << 4)), 0x5410);
}

// the low m bytes of a word
__device__ __forceinline__ constexpr uint32_t low_bytes(int m) {
  return m >= 4 ? 0xffffffffu : (1u << (8 * m)) - 1u;
}

// out[n, oy, ox0 .. ox0+R-1, c0 .. c0+kVec-1] for one thread; KH x KH
// taps, horizontal stride SW, any vertical stride, dilation 1,
// multiplier 1.
template <int KH, int SW, int R, bool WZP, class Ep>
__global__ void __launch_bounds__(kMaxThreads)
    qdwconv_strip_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         int8_t* __restrict__ out, int h, int wd, int c,
                         int oh, int ow, int sh, int pt, int pl, int x_zp,
                         int groups, int strips, Ep ep) {
  constexpr int KW = KH;
  constexpr int COLS = (R - 1) * SW + KW;  // input columns of the strip
  constexpr int NG = (KH + 3) / 4;         // row groups of one dp4a each
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  if (g >= groups || s >= strips) return;
  const int n = blockIdx.z / oh;  // uniform over the block
  const int oy = blockIdx.z - n * oh;
  const int c0 = g * kVec;
  const int ox0 = s * R;

  // every load first: weights, epilogue parameters, the input window
  uint32_t wr[KH * KW];
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) wr[t] = load_px(w + t * c + c0);
  typename Ep::Params prm[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) prm[v] = ep.params(c0 + v);

  const uint32_t zp4 = 0x01010101u * static_cast<uint8_t>(x_zp);
  const int8_t* img = x + n * h * wd * c + c0;  // < 2^31: checked in Python
  const int iy0 = oy * sh - pt;
  const int ix0 = ox0 * SW - pl;
  uint32_t xr[KH][COLS];
#pragma unroll
  for (int dy = 0; dy < KH; ++dy) {
    const int iy = iy0 + dy;
    const bool row_in = iy >= 0 && iy < h;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int ix = ix0 + j;
      xr[dy][j] = row_in && ix >= 0 && ix < wd
                      ? load_px(img + (iy * wd + ix) * c)
                      : zp4;
    }
  }

  int32_t acc[R][kVec];
  int32_t rs[R][kVec];
#pragma unroll
  for (int b = 0; b < kVec; ++b) {  // channel c0 + b, byte b of each word
    // the weights of horizontal tap dx, rows gathered per dp4a, the bytes
    // past kh zeroed (the input's bytes there are left as they fall)
    uint32_t wp[KW][NG];
#pragma unroll
    for (int dx = 0; dx < KW; ++dx) {
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int y = 4 * k;
        const int m = KH - y < 4 ? KH - y : 4;
        auto row = [&](int i) {
          return y + i < KH ? wr[(y + i) * KW + dx] : 0u;
        };
        wp[dx][k] = gather(row(0), row(1), row(2), row(3), m, b) &
                    low_bytes(m);
      }
    }
    uint32_t xp[COLS][NG];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int y = 4 * k;
        const int m = KH - y < 4 ? KH - y : 4;
        auto row = [&](int i) { return y + i < KH ? xr[y + i][j] : 0u; };
        xp[j][k] = gather(row(0), row(1), row(2), row(3), m, b);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int32_t a = 0;
      int32_t sum = 0;
#pragma unroll
      for (int dx = 0; dx < KW; ++dx) {
#pragma unroll
        for (int k = 0; k < NG; ++k) {
          const int m = KH - 4 * k < 4 ? KH - 4 * k : 4;
          const int xv = static_cast<int>(xp[r * SW + dx][k]);
          a = __dp4a(xv, static_cast<int>(wp[dx][k]), a);
          if constexpr (WZP) {
            sum = __dp4a(xv, static_cast<int>(0x01010101u & low_bytes(m)),
                         sum);
          }
        }
      }
      acc[r][b] = a;
      rs[r][b] = sum;
    }
  }

  int8_t* dst = out + ((n * oh + oy) * ow + ox0) * c + c0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (ox0 + r >= ow) break;
    uint32_t o = 0;
#pragma unroll
    for (int b = 0; b < kVec; ++b) {
      const int8_t y = ep.apply(acc[r][b], WZP ? rs[r][b] : 0, prm[b]);
      o |= static_cast<uint32_t>(static_cast<uint8_t>(y)) << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(dst + r * c) = o;
  }
}

struct DwArgs {
  const int8_t* x;
  const int8_t* w;
  int8_t* out;
  int n, h, wd, ci, mult, oh, ow, kh, kw, sh, sw, dh, dw, pt, pl, x_zp;
  dim3 grid, block;
  cudaStream_t stream;
};

template <int KH, int SW, int R, bool WZP, class Ep>
int launch_strip(const DwArgs& a, const Ep& ep) {
  const int groups = a.ci / kVec;
  const int strips = (a.ow + R - 1) / R;
  qdwconv_strip_kernel<KH, SW, R, WZP, Ep>
      <<<a.grid, a.block, 0, a.stream>>>(a.x, a.w, a.out, a.h, a.wd, a.ci,
                                         a.oh, a.ow, a.sh, a.pt, a.pl, a.x_zp,
                                         groups, strips, ep);
  return static_cast<int>(cudaGetLastError());
}

// The strip kernel's variants (kh, sw, R), in the order of qdwconv.py
// VARIANTS.
template <bool WZP, class Ep>
int launch_variant(int variant, const DwArgs& args, const Ep& ep) {
  switch (variant) {
    case 0: return launch_strip<3, 1, 1, WZP>(args, ep);
    case 1: return launch_strip<3, 1, 2, WZP>(args, ep);
    case 2: return launch_strip<3, 1, 4, WZP>(args, ep);
    case 3: return launch_strip<3, 2, 1, WZP>(args, ep);
    case 4: return launch_strip<3, 2, 2, WZP>(args, ep);
    case 5: return launch_strip<3, 2, 4, WZP>(args, ep);
    case 6: return launch_strip<5, 1, 2, WZP>(args, ep);
    case 7: return launch_strip<5, 2, 2, WZP>(args, ep);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// variant < 0: the general branch, grid.x blocks of block.x threads
template <class Ep>
int launch_qdwconv(const DwArgs& a, int variant, int w_zp, const Ep& ep) {
  if (variant >= 0) {
    return w_zp != 0 ? launch_variant<true>(variant, a, ep)
                     : launch_variant<false>(variant, a, ep);
  }
  const int total = a.n * a.oh * a.ow * a.ci * a.mult;
  qdwconv_kernel<Ep><<<a.grid, a.block, 0, a.stream>>>(
      a.x, a.w, a.out, total, a.h, a.wd, a.ci, a.mult, a.oh, a.ow, a.kh, a.kw,
      a.sh, a.sw, a.dh, a.dw, a.pt, a.pl, a.x_zp, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band

extern "C" int band_qdwconv2d_exact(
    const void* x, const void* w, const void* bias, const void* qm,
    const void* shift, void* out, int n, int h, int wd, int ci, int mult,
    int oh, int ow, int kh, int kw, int sh, int sw, int dh, int dw, int pt,
    int pl, int qstride, int x_zp, int w_zp, int out_zp, int qmin, int qmax,
    int rounding, int variant, int gx, int gy, int gz, int bx, int by,
    void* stream) {
  using namespace band;
  const Epilogue ep{static_cast<const int32_t*>(bias),
                    static_cast<const int32_t*>(qm),
                    static_cast<const int32_t*>(shift),
                    qstride, w_zp, out_zp, qmin, qmax, rounding};
  const DwArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                 static_cast<int8_t*>(out), n, h, wd, ci, mult, oh, ow, kh, kw,
                 sh, sw, dh, dw, pt, pl, x_zp, dim3(gx, gy, gz), dim3(bx, by),
                 static_cast<cudaStream_t>(stream)};
  return launch_qdwconv(a, variant, w_zp, ep);
}

extern "C" int band_qdwconv2d_fast(
    const void* x, const void* w, const void* bias, const void* mult_f,
    void* out, int n, int h, int wd, int ci, int mult, int oh, int ow, int kh,
    int kw, int sh, int sw, int dh, int dw, int pt, int pl, int mstride,
    int x_zp, int w_zp, int out_zp, int qmin, int qmax, int variant, int gx,
    int gy, int gz, int bx, int by, void* stream) {
  using namespace band;
  const FastEpilogue ep{static_cast<const int32_t*>(bias),
                        static_cast<const float*>(mult_f), mstride, w_zp,
                        out_zp, qmin, qmax};
  const DwArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                 static_cast<int8_t*>(out), n, h, wd, ci, mult, oh, ow, kh, kw,
                 sh, sw, dh, dw, pt, pl, x_zp, dim3(gx, gy, gz), dim3(bx, by),
                 static_cast<cudaStream_t>(stream)};
  return launch_qdwconv(a, variant, w_zp, ep);
}
