// Int8 NHWC convolution with a fused requant epilogue: the exact TFLite
// requant (kernel B2) and, as a template instance of the same source, the
// float32 requant of fast numerics.
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
// What bounds it on the H100.  The convs of the slice models are stems
// and other small-Ci 3x3 convs: MobileNetV2's stem (224^2 x 3 -> 112^2 x
// 32, 3x3 s2, K = 27) moves ~0.55 MB (0.165 us at 3.35 TB/s) and needs
// ~3.6 M dp4a, well under 1 us of the card's integer units.  So the
// launch, one round trip to memory, and the halo decide the time.  The
// first port ran them through the implicit-GEMM loop of qgemm.cuh, which
// at Ci = 3 decodes each byte of an A word with two divisions and a
// bounds test, transposes B byte by byte on every K tile, and leaves half
// of its 64-wide N tile empty at Oc = 32: 6.2 us for the stem.
//
// The design (the direct kernel, qconv.py conv_plan picks it):
//  1. A block owns a tile of th x tw output pixels and all Oc.  It stages
//     its input patch, the tile plus the halo of stride, dilation and
//     kernel size, in shared memory once, with neighbouring threads on
//     neighbouring pixels.  Positions outside the image hold x_zp, so the
//     inner loop tests no bounds.
//  2. Channels are padded to WP 32-bit words per pixel (Ci <= 4, 8, 16: WP
//     = 1, 2, 4, a template parameter) with ZERO bytes, in the patch and
//     in the weights: one __dp4a covers 4 channels of one tap.  The window
//     sum that w_zp multiplies is a dp4a of the same words with
//     0x01010101, which is right only because the pad byte is 0, not x_zp.
//  3. The weights (kh*kw*WP words x Oc) are staged once per block as
//     dp4a words, [tap][word][oc], so a thread's CV channels of one tap
//     word are CV/4 16-byte shared-memory loads.  A staging item reads
//     the 4 rows of [K][Oc] that make one word, 8 output channels wide
//     (four 8-byte loads), and transposes them in registers with
//     __byte_perm: no byte gather from device memory, no second pass.
//  4. At these sizes the kernel is bound by latency, not by bytes or
//     multiplies: a warp stalls at the first use of a load, so loads that
//     are each used before the next one issues cost a round trip each
//     (~0.1-0.3 us).  So every staging load is unconditional, from an
//     address clamped into the tensor, and a thread issues all of its
//     round's loads (and its epilogue parameters) before it uses any; index
//     splits are high multiplies (FastDiv), not divisions.  (Byte gathers
//     used as they arrived took 1.9 us of the stem's 4.6 and 4.1 us of a
//     16-channel conv's 6.1, PERF.md.)
//  5. A thread owns P = 1 or 2 output pixels (spaced by the block's pixel
//     threads, so that a warp covers neighbouring pixels) x CV = 8
//     channels.  Each weight vector serves its P pixels; each output
//     pixel's 8 bytes leave in one store.  3x3 taps are unrolled (a
//     template case: ~10% on the small convs, PERF.md).
//  6. Anything else (Ci above 16, Oc not a multiple of 8 or above 64, a
//     patch and weights beyond 48 KB of shared memory) takes the general
//     branch, qconv_mma.cuh's tensor-core implicit GEMM, with the tile
//     the plan picks from the shape.  qgemm.cuh's __dp4a loop, the first
//     port's general branch, is picked by no plan: it stays behind the
//     forcing hook as the yardstick that chip_smoke.py times beside the
//     mma branch.
//
// Exactness: dp4a sums int8 products into int32 with the int32 wrap, and
// the w_zp and bias terms are added in uint32 in the epilogue, as in the
// plain version.
#include <cuda_runtime.h>

#include <cstdint>

#include "qconv_mma.cuh"
#include "qgemm.cuh"

namespace band {

constexpr int kDirectMaxThreads = 256;  // the direct kernel's launch bound

// the geometry of a direct launch; the plan (qconv.py conv_plan) fixes the
// tile (th, tw) and the patch (ph, pw) it stages
struct DirectGeom {
  int H, W, Ci, OH, OW, Oc, kh, kw, sh, sw, dh, dw, pt, pl;
  int x_zp;
  int th, tw;   // output tile of a block
  int ph, pw;   // input patch of a block
  FastDiv by_oct, by_pw;  // by Oc / 8, by pw
};

// 4 words (rows) of 4 bytes (columns) -> 4 words, one per column: word j
// of *out holds byte j of r[0], r[1], r[2], r[3]
__device__ __forceinline__ void transpose4x4(const uint32_t r[4], uint4* out) {
  const uint32_t a = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t b = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t c = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t d = __byte_perm(r[2], r[3], 0x7362);
  *out = make_uint4(__byte_perm(a, c, 0x5410), __byte_perm(a, c, 0x7632),
                    __byte_perm(b, d, 0x5410), __byte_perm(b, d, 0x7632));
}

// WP 32-bit words per pixel and tap: Ci <= 4 * WP channels, zero bytes
// past Ci.  CV channels and P pixels per thread.  KS: square taps of that
// size, unrolled (3: every B2 call of the slice models), or 0: kh x kw
// from g.
template <int CV, int P, int WP, int KS, bool WZP, class Ep>
__global__ void __launch_bounds__(kDirectMaxThreads)
    qconv_direct_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        int8_t* __restrict__ out, DirectGeom g, Ep ep) {
  static_assert(CV == 8, "a pixel's channels leave in one 8-byte store");
  // weight items (4 rows x 8 oc) and patch pixels a thread stages per
  // round trip
  constexpr int kW = 2;
  constexpr int kPix = 4 / WP;
  extern __shared__ __align__(16) uint32_t smem[];
  const int octets = g.Oc / 8;
  const int nw = g.kh * g.kw * WP * octets;  // weight items: (tap, word, octet)
  const int nx = g.ph * g.pw;                // patch items: pixels
  const int K = g.kh * g.kw * g.Ci;          // weight rows
  uint32_t* s_w = smem;                      // [tap][word][oc]
  uint32_t* s_x = smem + g.kh * g.kw * WP * g.Oc;  // [ph][pw][word]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * g.th;
  const int ox0 = blockIdx.x * g.tw;

  // this thread's channels and epilogue parameters, loaded first so that
  // their loads overlap the staging
  const int groups = g.Oc / CV;
  const int cg = tid % groups;
  const int pthr = tid / groups;
  const int npt = nt / groups;  // pixel threads: npt * P = th * tw
  const int c0 = cg * CV;
  typename Ep::Params prm[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) prm[c] = ep.params(c0 + c);

  // 1. one round trip to memory: the weights (an item: 4 rows of K, the
  // channels of one dp4a word of one tap, x 8 output channels, 8 bytes a
  // row) and the input patch (each pixel's Ci bytes).  Every load is
  // unconditional, from an address clamped into the tensor, so that all
  // of them issue before the first value is used; what a clamp fetched is
  // then dropped or replaced (zero rows and pad bytes past Ci, x_zp
  // outside the image).  An item's 4 x 8 bytes are transposed in
  // registers into 8 dp4a words, one per output channel.
  const uint2* w8 = reinterpret_cast<const uint2*>(w);
  const int8_t* img = x + static_cast<size_t>(n) * g.H * g.W * g.Ci;
  const int8_t zp = static_cast<int8_t>(g.x_zp);
  const int iy0 = oy0 * g.sh - g.pt;
  const int ix0 = ox0 * g.sw - g.pl;
  for (int round = 0; round * kW * nt < nw || round * kPix * nt < nx;
       ++round) {
    const int rw = tid + round * kW * nt;  // this round's first items
    const int rx = tid + round * kPix * nt;
    uint2 wr[kW][4];
    int8_t xb[kPix][4 * WP];
    bool in[kPix];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int i = min(rw + k * nt, nw - 1);
      const int tq = g.by_oct(i);         // tap * WP + word
      const int t = tq / WP;
      const int c = 4 * (tq - t * WP);    // the word's first channel
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wr[k][e] = w8[(min(t * g.Ci + c + e, K - 1) * g.Oc) / 8 + i - tq * octets];
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int i = min(rx + k * nt, nx - 1);
      const int py = g.by_pw(i);
      const int iy = iy0 + py;
      const int ix = ix0 + i - py * g.pw;
      in[k] = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const int8_t* p = img + (static_cast<size_t>(in[k] ? iy : 0) * g.W +
                               (in[k] ? ix : 0)) * g.Ci;
#pragma unroll
      for (int c = 0; c < 4 * WP; ++c) xb[k][c] = p[min(c, g.Ci - 1)];
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int i = rw + k * nt;
      const int tq = g.by_oct(i);
      const int c = 4 * (tq - tq / WP * WP);
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool real = c + e < g.Ci;
        lo[e] = real ? wr[k][e].x : 0u;
        hi[e] = real ? wr[k][e].y : 0u;
      }
      uint4 a, b;
      transpose4x4(lo, &a);
      transpose4x4(hi, &b);
      if (i < nw) {
        uint4* dst = reinterpret_cast<uint4*>(s_w + tq * g.Oc + 8 * (i - tq * octets));
        dst[0] = a;
        dst[1] = b;
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int i = rx + k * nt;
#pragma unroll
      for (int q = 0; q < WP; ++q) {
        uint32_t v = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * q + e;
          v |= byte_at(c >= g.Ci ? 0 : in[k] ? xb[k][c] : zp, e);
        }
        if (i < nx) s_x[i * WP + q] = v;
      }
    }
  }
  // this thread's pixels: their offsets in the patch
  int base[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int pix = pthr + j * npt;
    const int ty = pix / g.tw;
    base[j] = (ty * g.sh * g.pw + (pix - ty * g.tw) * g.sw) * WP;
  }
  __syncthreads();

  // 2. the taps: per tap word, CV weights by 16-byte loads, then P x CV
  // dp4a (and P window-sum dp4a when w_zp != 0)
  int32_t acc[P][CV];
  int32_t rs[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    rs[j] = 0;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[j][c] = 0;
  }
  const int kh = KS ? KS : g.kh;
  const int kw = KS ? KS : g.kw;
#pragma unroll
  for (int dy = 0; dy < kh; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kw; ++dx) {
      const int xo = (dy * g.dh * g.pw + dx * g.dw) * WP;
      const uint32_t* wt = s_w + (dy * kw + dx) * WP * g.Oc + c0;
#pragma unroll
      for (int q = 0; q < WP; ++q) {
        uint32_t wv[CV];
#pragma unroll
        for (int k = 0; k < CV / 4; ++k) {
          const uint4 v = *reinterpret_cast<const uint4*>(wt + q * g.Oc + 4 * k);
          wv[4 * k] = v.x;
          wv[4 * k + 1] = v.y;
          wv[4 * k + 2] = v.z;
          wv[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int xv = static_cast<int>(s_x[base[j] + xo + q]);
#pragma unroll
          for (int c = 0; c < CV; ++c)
            acc[j][c] = __dp4a(xv, static_cast<int>(wv[c]), acc[j][c]);
          if constexpr (WZP) rs[j] = __dp4a(xv, 0x01010101, rs[j]);
        }
      }
    }
  }

  // 3. requant, and each pixel's CV bytes in one store
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int pix = pthr + j * npt;
    const int ty = pix / g.tw;
    const int oy = oy0 + ty;
    const int ox = ox0 + pix - ty * g.tw;
    if (oy >= g.OH || ox >= g.OW) continue;
    uint32_t pk[CV / 4];
#pragma unroll
    for (int k = 0; k < CV / 4; ++k) pk[k] = 0u;
#pragma unroll
    for (int c = 0; c < CV; ++c)
      pk[c / 4] |= byte_at(ep.apply(acc[j][c], rs[j], prm[c]), c % 4);
    int8_t* dst = out + ((static_cast<size_t>(n) * g.OH + oy) * g.OW + ox) * g.Oc + c0;
    *reinterpret_cast<uint2*>(dst) = make_uint2(pk[0], pk[1]);
  }
}

// the direct kernel's variants (CV, P), in the order of qconv.py
// DIRECT_VARIANTS, each for 1, 2 and 4 words per pixel (qconv.py
// direct_words) and for 3x3 and any taps
template <int WP, int KS, bool WZP, class Ep>
cudaError_t launch_variant(int variant, dim3 grid, int threads, int smem,
                           cudaStream_t s, const int8_t* x, const int8_t* w,
                           int8_t* out, const DirectGeom& g, const Ep& ep) {
  switch (variant) {
    case 0: qconv_direct_kernel<8, 1, WP, KS, WZP, Ep><<<grid, threads, smem, s>>>(x, w, out, g, ep); break;
    case 1: qconv_direct_kernel<8, 2, WP, KS, WZP, Ep><<<grid, threads, smem, s>>>(x, w, out, g, ep); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int WP, bool WZP, class Ep>
cudaError_t launch_taps(int variant, dim3 grid, int threads, int smem,
                        cudaStream_t s, const int8_t* x, const int8_t* w,
                        int8_t* out, const DirectGeom& g, const Ep& ep) {
  return g.kh == 3 && g.kw == 3
             ? launch_variant<WP, 3, WZP>(variant, grid, threads, smem, s, x, w, out, g, ep)
             : launch_variant<WP, 0, WZP>(variant, grid, threads, smem, s, x, w, out, g, ep);
}

template <bool WZP, class Ep>
cudaError_t launch_direct(int variant, dim3 grid, int threads, int smem,
                          cudaStream_t s, const int8_t* x, const int8_t* w,
                          int8_t* out, const DirectGeom& g, const Ep& ep) {
  if (g.Ci <= 4)
    return launch_taps<1, WZP>(variant, grid, threads, smem, s, x, w, out, g, ep);
  if (g.Ci <= 8)
    return launch_taps<2, WZP>(variant, grid, threads, smem, s, x, w, out, g, ep);
  if (g.Ci <= 16)
    return launch_taps<4, WZP>(variant, grid, threads, smem, s, x, w, out, g, ep);
  return cudaErrorInvalidValue;
}

// A launch plan from qconv.py conv_plan.  branch 0: a direct variant with
// its tile, patch, grid, block and dynamic shared memory; 1: the mma
// branch (variant: the N tile, 8 << variant columns), with its tile,
// patch, slabs a channel group, gathering or not, grid and shared memory;
// 2: qgemm.cuh's loop (which sizes its own grid).
struct ConvPlan {
  int branch, variant, th, tw, ph, pw, gx, gy, gz, threads, smem, slabs,
      gather;
};

template <class Ep>
int launch_qconv(const void* x, const void* w, void* out, int n, int h,
                 int wd, int ci, int oh, int ow, int oc, int kh, int kw,
                 int sh, int sw, int dh, int dw, int pt, int pl, int x_zp,
                 const Ep& ep, const ConvPlan& p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* px = static_cast<const int8_t*>(x);
  const int8_t* pw = static_cast<const int8_t*>(w);
  int8_t* po = static_cast<int8_t*>(out);
  if (p.branch == 0) {
    const DirectGeom g{h, wd, ci, oh, ow, oc, kh, kw, sh, sw, dh, dw, pt, pl,
                       x_zp, p.th, p.tw, p.ph, p.pw, FastDiv(oc / 8),
                       FastDiv(p.pw)};
    const dim3 grid(p.gx, p.gy, p.gz);
    const cudaError_t err =
        ep.w_zp != 0
            ? launch_direct<true>(p.variant, grid, p.threads, p.smem, s, px, pw, po, g, ep)
            : launch_direct<false>(p.variant, grid, p.threads, p.smem, s, px, pw, po, g, ep);
    return static_cast<int>(err);
  }
  if (p.branch == 1)
    return static_cast<int>(launch_mma(
        p.variant, p.th, p.tw, p.ph, p.pw, p.slabs, p.gather != 0, p.gx,
        p.gy, p.smem, s, px, pw, po, n, h, wd, ci, oh, ow, oc, kh, kw, sh,
        sw, dh, dw, pt, pl, x_zp, ep));
  if (p.branch != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int M = n * oh * ow;
  const int K = kh * kw * ci;
  const dim3 grid((M + kBM - 1) / kBM, (oc + kBN - 1) / kBN);
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
    int rounding, int branch, int variant, int th, int tw, int ph, int pw,
    int gx, int gy, int gz, int threads, int smem, int slabs, int gather,
    void* stream) {
  using namespace band;
  const Epilogue ep{static_cast<const int32_t*>(bias),
                    static_cast<const int32_t*>(qm),
                    static_cast<const int32_t*>(shift),
                    qstride, w_zp, out_zp, qmin, qmax, rounding};
  const ConvPlan p{branch, variant, th, tw, ph, pw, gx, gy,
                   gz, threads, smem, slabs, gather};
  return launch_qconv(x, w, out, n, h, wd, ci, oh, ow, oc, kh, kw, sh, sw, dh,
                      dw, pt, pl, x_zp, ep, p, stream);
}

extern "C" int band_qconv2d_fast(
    const void* x, const void* w, const void* bias, const void* mult,
    void* out, int n, int h, int wd, int ci, int oh, int ow, int oc, int kh,
    int kw, int sh, int sw, int dh, int dw, int pt, int pl, int mstride,
    int x_zp, int w_zp, int out_zp, int qmin, int qmax, int branch,
    int variant, int th, int tw, int ph, int pw, int gx, int gy, int gz,
    int threads, int smem, int slabs, int gather, void* stream) {
  using namespace band;
  const FastEpilogue ep{static_cast<const int32_t*>(bias),
                        static_cast<const float*>(mult), mstride, w_zp,
                        out_zp, qmin, qmax};
  const ConvPlan p{branch, variant, th, tw, ph, pw, gx, gy,
                   gz, threads, smem, slabs, gather};
  return launch_qconv(x, w, out, n, h, wd, ci, oh, ow, oc, kh, kw, sh, sw, dh,
                      dw, pt, pl, x_zp, ep, p, stream);
}
