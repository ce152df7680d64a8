// B2's general branch on Hopper's tensor cores: an implicit GEMM of an int8
// NHWC convolution from an input patch staged in shared memory, with the
// requant epilogue fused (requant.cuh: exact or fast, or the hybrid one
// with float32 out, whose padded taps take each image's own zero point).
// Included by qconv.cu, whose conv_plan routes here every conv that its
// direct kernel does not take, and whose band_qconv2d_hybrid launches it
// for a dynamic-range TRANSPOSE_CONV's union conv (its time: PERF.md).
//
// What bounds it on the H100.  FSRCNN x2 at 360x640 sends this branch its
// deconv (one union conv of the four sub-pixel phases: 5x5 taps, Ci 56,
// Oc 4; x is 12.9 MB, read once: 3.9 us at 3.35 TB/s; 1.3 G int8 MACs
// padded to 8 columns, ~3 us of mma.sync) and four 3x3 12 -> 12 convs
// (2.8 MB each way: 1.7 us).  Both are bound by bytes; what the qgemm.cuh
// loop it replaces wasted was elsewhere: a 64-wide N tile of which 1 to 12
// columns were real, two divisions and a bounds test per A word straight
// from device memory, and B transposed byte by byte on every K tile.
//
// The design:
//  1. A block of 4 warps owns th x tw output pixels of one image (BM = 128
//     or 256, tw a multiple of 16, so that an m16 tile is 16 neighbouring
//     pixels of one output row) and BN = 8, 16 or 32 output channels (the
//     plan takes the narrowest that holds Oc; column tiles on grid y, all
//     pixel tiles on grid x, which takes 2^31 - 1 blocks).
//  2. It stages its input patch, the tile plus the halo of stride,
//     dilation and taps, in shared memory once per channel group: each
//     pixel holds gs slabs of 16 channels, ZERO bytes past Ci (the window
//     sum that w_zp multiplies counts every byte of a row), x_zp at
//     positions outside the image.  The pixel stride is an odd number of
//     16-byte units, so the 8 row addresses of an ldmatrix phase fall in 8
//     different 16-byte bank groups.  Copies are cp.async of 16, 8 or 4
//     bytes where Ci and x's base allow it, else byte loads.  A large Ci
//     takes several channel groups, one after the other.  Where no patch
//     fits (a dilation or stride so large that the halo outgrows shared
//     memory), the block gathers instead: one tap at a time, it stages
//     just the input pixel of each output pixel for that tap (th x tw
//     pixels, the tap's offset and the stride applied while copying), and
//     the taps and channel groups take turns.
//  3. K is enumerated in 16-byte chunks (tap, slab), tap-major; one
//     m16n8k32 step takes two.  A table in shared memory holds each
//     chunk's offset in the patch, so the inner loop adds it to a row base
//     worked out once per lane: no division, no bounds test.  An odd count
//     gets one zero chunk: zero weights, and no ones in the window sum's B
//     fragment.  ldmatrix.x4 loads the A fragments (16 pixels x 2 chunks).
//  4. The weights of the block's columns are staged per group from the
//     prepared [kh*kw*Ci, Oc] layout: an item reads 4 K rows x 4 columns
//     (one 32-bit load a row where Oc and the base allow it) and
//     transposes them in registers (__byte_perm) into 4 K-contiguous words,
//     [column][K] with an odd number of 16-byte units per column, which
//     ldmatrix loads as the B fragments.  Columns past Oc and channels past
//     Ci are zero.
//  5. The window sum, when w_zp != 0, is one more MMA per step against an
//     all-ones B fragment, as in qmatmul.cu.
//
// Exactness: the tensor core adds int8 products into int32 exactly while
// no partial sum leaves int32; with |a * b| <= 2^14 that holds for a group
// of fewer than 2^17 bytes of K (padding included), and conv_plan keeps
// every group below that.  Each group's sums (and window sums) are added
// into uint32 totals, i.e. modulo 2^32, as B1 adds its split-K partials
// (qmatmul.cu): any slicing of K then gives the low 32 bits of the exact
// sum, the plain version's int32 wrap.  The w_zp and bias terms are added
// in uint32 in the epilogue, as in the plain version.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma.cuh"
#include "requant.cuh"

namespace band {

// n / d without a division instruction, for n < 2^32 / d: one high
// multiply by m = ceil(2^32 / d), exact since n * (m * d - 2^32) < 2^32
// (d == 1 passes n through)
struct FastDiv {
  uint32_t d, m;
  FastDiv() = default;
  explicit FastDiv(int div)
      : d(static_cast<uint32_t>(div)),
        m(div == 1 ? 0u
                   : static_cast<uint32_t>((0x100000000ull + div - 1) / div)) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1u ? n
                   : static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
  }
};

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kChunk = 16;  // K bytes of a chunk: one tap, 16 channels

// the geometry of an mma launch: the plan's tile, patch and channel group
// (conv_plan), the rest derived from the shape in launch_mma
struct MmaGeom {
  int H, W, Ci, OH, OW, Oc, kh, kw, sh, sw, dh, dw, pt, pl, x_zp;
  int th, tw;        // output tile of a block
  int ph, pw;        // input patch of a block (th x tw when gathering)
  int gs;            // slabs of 16 channels in a channel group
  int groups;        // channel groups: ceil(ceil(Ci / 16) / gs)
  int taps;          // tap groups: 1, or kh * kw when gathering
  int tkh, tkw;      // taps of a tap group: kh x kw, or 1 x 1
  int ssh, ssw;      // input step between patch pixels: 1, or sh, sw
  int psh, psw;      // patch step between output pixels: sh, sw, or 1
  int ps;            // patch bytes a pixel: 16 (gs | 1)
  int ws;            // weight bytes a column: 32 ksteps + 16
  int tiles_x, tiles_y;
  int vx;            // patch copy width: 16, 8, 4 or 1
  bool vw;           // weights read 4 columns at a time
  FastDiv by_cpp, by_pw, by_gs, by_kw;  // by copies a pixel, pw, gs, tkw
};

// bytes of dynamic shared memory of an mma block: the patch, the weights
// of BN columns and the chunk table
__host__ __device__ inline int mma_smem(int ph, int pw, int ps, int bn,
                                        int ws, int ksteps) {
  return ph * pw * ps + bn * ws + 4 * 2 * ksteps;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// V bytes of shared memory, each the low byte of v (4 equal bytes)
template <int V>
__device__ __forceinline__ void fill(uint8_t* dst, uint32_t v) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v, v, v, v);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v, v);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(dst) = v;
  } else {
    *dst = static_cast<uint8_t>(v);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// The patch of one group: ph x pw pixels of gs * 16 bytes from channel
// cbase, pixel (py, px) at input (iy0 + py ssh, ix0 + px ssw), V bytes a
// copy (V divides Ci, so a copy lies wholly below or wholly past Ci):
// cp.async inside the image (zeros past Ci), ``pad`` bytes outside it
// (zeros past Ci): x_zp, or a hybrid image's own zero point.
template <int V>
__device__ __forceinline__ void stage_patch(uint8_t* s_x, const int8_t* img,
                                            const MmaGeom& g, int iy0,
                                            int ix0, int cbase, int pad,
                                            int tid) {
  const int cpp = g.gs * kChunk / V;
  const int items = g.ph * g.pw * cpp;
  const uint32_t zp4 = static_cast<uint32_t>(static_cast<uint8_t>(pad)) *
                       0x01010101u;
#pragma unroll 4
  for (int i = tid; i < items; i += kMmaThreads) {
    const int p = g.by_cpp(i);
    const int c = cbase + (i - p * cpp) * V;
    const int py = g.by_pw(p);
    const int iy = iy0 + py * g.ssh;
    const int ix = ix0 + (p - py * g.pw) * g.ssw;
    const bool real = c < g.Ci;
    uint8_t* dst = s_x + p * g.ps + (c - cbase);
    if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
      const int8_t* src =
          img + (static_cast<size_t>(iy) * g.W + ix) * g.Ci + (real ? c : 0);
      if constexpr (V == 1) {
        *dst = real ? static_cast<uint8_t>(*src) : 0;
      } else {
        cp_async<V>(dst, src, real);
      }
    } else {
      fill<V>(dst, real ? zp4 : 0u);
    }
  }
}

// The weights of columns n0..n0+BN-1 and one group, [column][K]: byte k
// of a column is chunk k / 16 (tap t of the group, slab s) channel cbase +
// 16 s + k % 16, weight row (tap0 + t) * Ci + that channel; zero past the
// group's chunks, past Ci and past Oc.
template <int BN>
__device__ __forceinline__ void stage_weights(uint8_t* s_w, const int8_t* w,
                                              const MmaGeom& g, int n0,
                                              int tap0, int cbase,
                                              int nchunks, int kg, int tid) {
  constexpr int Q4 = BN / 4;  // 4-column items a K word
  const int items = (kg / 4) * Q4;
#pragma unroll 2
  for (int i = tid; i < items; i += kMmaThreads) {
    const int n4 = i % Q4;
    const int kb = 4 * (i / Q4);
    const int c = kb / kChunk;
    const int t = g.by_gs(c);
    const int ch = cbase + kChunk * (c - t * g.gs) + kb % kChunk;
    const int col = n0 + 4 * n4;
    uint32_t r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = c < nchunks && ch + e < g.Ci;
      const int8_t* row =
          w + static_cast<size_t>((tap0 + t) * g.Ci + ch + e) * g.Oc;
      if (g.vw) {
        r[e] = ok && col < g.Oc
                   ? *reinterpret_cast<const uint32_t*>(row + col)
                   : 0u;
      } else {
        r[e] = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ok && col + q < g.Oc)
            r[e] |= static_cast<uint32_t>(static_cast<uint8_t>(row[col + q]))
                    << (8 * q);
      }
    }
    uint32_t o[4];
    transpose4x4(r[0], r[1], r[2], r[3], o);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<uint32_t*>(s_w + (4 * n4 + q) * g.ws + kb) = o[q];
  }
}

// out[n, oy, ox, n0 + j] for the block's th x tw pixels and BN columns
// (int8, or float32 for the hybrid epilogue, which is bound to image n:
// its zero point fills the padded taps);
// MI m16 tiles a warp (BM = 64 MI pixels), NJ n8 tiles (BN = 8 NJ).
// SPLIT: more than one group, whose sums go through uint32 totals.  A
// single group keeps no totals, so fewer registers and more blocks an SM
// (on the H100, FSRCNN's 3x3 convs: 0.023 ms with the totals, 0.0175
// without; PERF.md).
template <int MI, int NJ, bool SPLIT, class Ep>
__global__ void __launch_bounds__(kMmaThreads)
    qconv_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     typename Ep::Out* __restrict__ out, MmaGeom g,
                     const Ep ep_all) {
  constexpr int BN = 8 * NJ;
  extern __shared__ __align__(16) uint8_t sbuf[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;   // thread in group
  // pixel tiles on grid x: (image, tile row, tile column); columns on y
  int b = blockIdx.x;
  const int bx = b % g.tiles_x;
  b /= g.tiles_x;
  const int by = b % g.tiles_y;
  const int n = b / g.tiles_y;
  Ep ep = ep_all;
  ep.bind(n);
  const int pad = ep.fill(g.x_zp);
  const int oy0 = by * g.th;
  const int ox0 = bx * g.tw;
  const int n0 = blockIdx.y * BN;
  const int nchunks = g.tkh * g.tkw * g.gs;  // chunks of a group
  const int ksteps = (nchunks + 1) / 2;
  uint8_t* s_x = sbuf;
  uint8_t* s_w = sbuf + g.ph * g.pw * g.ps;
  int* s_tab = reinterpret_cast<int*>(s_w + BN * g.ws);

  // this thread's columns n0 + 8 j + 2 tq + e and their requant
  // parameters, loaded first so that their loads overlap the staging
  typename Ep::Params prm[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * j + 2 * tq + e;
      prm[j][e] = ep.params(col < g.Oc ? col : g.Oc - 1);
    }

  // each chunk's offset in the patch (the same for every group); the pad
  // chunk of an odd count points at chunk 0, whose weights there are zero
  for (int c = tid; c < 2 * ksteps; c += kMmaThreads) {
    int off = 0;
    if (c < nchunks) {
      const int t = g.by_gs(c);
      const int dy = g.by_kw(t);
      off = (dy * g.dh * g.pw + (t - dy * g.tkw) * g.dw) * g.ps +
            kChunk * (c - t * g.gs);
    }
    s_tab[c] = off;
  }
  // A fragments by ldmatrix.x4: lane -> row (lane & 7) + 8 ((lane >> 3) & 1)
  // of an m16 tile and chunk lane >> 4 of a step; the row's pixel base in
  // the patch, worked out once
  const int ahalf = lane >> 4;
  uint32_t abase[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m = 16 * (MI * warp + mi) + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int ty = m / g.tw;
    abase[mi] = static_cast<uint32_t>(__cvta_generic_to_shared(s_x)) +
                (ty * g.psh * g.pw + (m - ty * g.tw) * g.psw) * g.ps;
  }
  // B fragments by ldmatrix: lane -> column 8 (lane >> 4) + (lane & 7) of
  // a pair of n8 tiles and chunk (lane >> 3) & 1 of a step
  const uint32_t bbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(s_w)) +
      (8 * (NJ > 1 ? lane >> 4 : 0) + (lane & 7)) * g.ws +
      kChunk * ((lane >> 3) & 1);

  // a group's int32 sums (exact) and their uint32 totals over the groups
  int32_t acc[MI][NJ][4];
  int32_t rs[MI][4];
  uint32_t tot[MI][NJ][4];
  uint32_t rtot[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rs[mi][r] = 0;
      if (r < 2) rtot[mi][r] = 0u;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[mi][j][r] = 0, tot[mi][j][r] = 0u;
    }
  const bool rowsum = ep.w_zp != 0;
  const int8_t* img = x + static_cast<size_t>(n) * g.H * g.W * g.Ci;
  const int iy0 = oy0 * g.sh - g.pt;
  const int ix0 = ox0 * g.sw - g.pl;

  // tap groups (one, or each tap when gathering) x channel groups
  for (int grp = 0; grp < g.taps * g.groups; ++grp) {
    const int tg = grp / g.groups;
    const int cbase = (grp - tg * g.groups) * g.gs * kChunk;
    const int tdy = tg / g.kw;  // the tap a gathering group stages
    const int iyg = iy0 + tdy * g.dh;
    const int ixg = ix0 + (tg - tdy * g.kw) * g.dw;
    if (grp > 0) __syncthreads();  // every warp is done with the last group
    switch (g.vx) {
      case 16: stage_patch<16>(s_x, img, g, iyg, ixg, cbase, pad, tid); break;
      case 8: stage_patch<8>(s_x, img, g, iyg, ixg, cbase, pad, tid); break;
      case 4: stage_patch<4>(s_x, img, g, iyg, ixg, cbase, pad, tid); break;
      default: stage_patch<1>(s_x, img, g, iyg, ixg, cbase, pad, tid);
    }
    stage_weights<BN>(s_w, w, g, n0, tg, cbase, nchunks, 32 * ksteps, tid);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t off = static_cast<uint32_t>(s_tab[2 * ks + ahalf]);
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a[mi], abase[mi] + off);
      uint32_t bf[NJ][2];
      if constexpr (NJ == 1) {
        ldmatrix_x2(bf[0], bbase + 2 * kChunk * ks);
      } else {
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t r[4];
          ldmatrix_x4(r, bbase + 16 * jp * g.ws + 2 * kChunk * ks);
          bf[2 * jp][0] = r[0];
          bf[2 * jp][1] = r[1];
          bf[2 * jp + 1][0] = r[2];
          bf[2 * jp + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8(acc[mi][j], a[mi], bf[j][0], bf[j][1]);
      if (rowsum) {
        const uint32_t hi = 2 * ks + 1 < nchunks ? 0x01010101u : 0u;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8(rs[mi], a[mi], 0x01010101u, hi);
      }
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < 2) rtot[mi][r] += static_cast<uint32_t>(rs[mi][2 * r]);
          rs[mi][r] = 0;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            tot[mi][j][r] += static_cast<uint32_t>(acc[mi][j][r]),
                acc[mi][j][r] = 0;
        }
    }
  }
  if constexpr (SPLIT) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r < 2) rs[mi][2 * r] = static_cast<int32_t>(rtot[mi][r]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[mi][j][r] = static_cast<int32_t>(tot[mi][j][r]);
      }
  }

  // requant: rows gq and gq + 8 of each m16 tile, columns 2 tq and 2 tq + 1
  // of each n8 tile; the window sum of a row is rs[mi][2 h]
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * (MI * warp + mi) + gq + 8 * h;
      const int ty = m / g.tw;
      const int oy = oy0 + ty;
      const int ox = ox0 + m - ty * g.tw;
      if (oy >= g.OH || ox >= g.OW) continue;
      typename Ep::Out* o =
          out + ((static_cast<size_t>(n) * g.OH + oy) * g.OW + ox) * g.Oc;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * tq + e;
          if (col < g.Oc)
            o[col] = ep.apply(acc[mi][j][2 * h + e], rs[mi][2 * h], prm[j][e]);
        }
    }
}

// the widest copy (16, 8 or 4 bytes) that a row length and a base allow,
// else 1
inline int mma_copy_width(const void* p, int len) {
  for (int v = 16; v >= 4; v /= 2)
    if (len % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0) return v;
  return 1;
}

template <int MI, int NJ, class Ep>
cudaError_t launch_mma_tile(dim3 grid, int smem, cudaStream_t s,
                            const int8_t* x, const int8_t* w,
                            typename Ep::Out* out, const MmaGeom& g,
                            const Ep& ep) {
  const bool split = g.taps * g.groups > 1;
  const auto kernel = split ? qconv_mma_kernel<MI, NJ, true, Ep>
                            : qconv_mma_kernel<MI, NJ, false, Ep>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kMmaThreads, smem, s>>>(x, w, out, g, ep);
  return cudaGetLastError();
}

// An mma launch from conv_plan's plan: N tile index nt (BN = 8 << nt),
// tile th x tw (64 MI pixels), patch ph x pw, gs slabs a group, gathering
// or not, grid and shared memory, each checked against what the shape
// gives.  ``out_v`` holds Ep::Out elements.
template <class Ep>
cudaError_t launch_mma(int nt, int th, int tw, int ph, int pw, int gs,
                       bool gather, int gx, int gy, int smem, cudaStream_t s,
                       const int8_t* x, const int8_t* w, void* out_v, int n,
                       int h, int wd, int ci, int oh, int ow, int oc, int kh,
                       int kw, int sh, int sw, int dh, int dw, int pt, int pl,
                       int x_zp, const Ep& ep) {
  const int bn = 8 << nt;
  const int nslab = (ci + kChunk - 1) / kChunk;
  MmaGeom g;
  g.taps = gather ? kh * kw : 1;
  g.tkh = gather ? 1 : kh;
  g.tkw = gather ? 1 : kw;
  g.ssh = gather ? sh : 1;
  g.ssw = gather ? sw : 1;
  g.psh = gather ? 1 : sh;
  g.psw = gather ? 1 : sw;
  const int ksteps = (g.tkh * g.tkw * gs + 1) / 2;
  g.H = h; g.W = wd; g.Ci = ci; g.OH = oh; g.OW = ow; g.Oc = oc;
  g.kh = kh; g.kw = kw; g.sh = sh; g.sw = sw; g.dh = dh; g.dw = dw;
  g.pt = pt; g.pl = pl; g.x_zp = x_zp;
  g.th = th; g.tw = tw; g.ph = ph; g.pw = pw; g.gs = gs;
  g.groups = gs > 0 ? (nslab + gs - 1) / gs : 0;
  g.ps = kChunk * (gs | 1);
  g.ws = 2 * kChunk * ksteps + kChunk;
  g.tiles_x = tw > 0 ? (ow + tw - 1) / tw : 0;
  g.tiles_y = th > 0 ? (oh + th - 1) / th : 0;
  g.vx = mma_copy_width(x, ci);
  g.vw = oc % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const bool ok =
      nt >= 0 && nt <= 2 && gs >= 1 && gs <= nslab && tw >= 1 &&
      (th * tw == 128 || th * tw == 256) &&
      ph == (th - 1) * g.psh + (g.tkh - 1) * dh + 1 &&
      pw == (tw - 1) * g.psw + (g.tkw - 1) * dw + 1 &&
      32 * ksteps < (1 << 17) &&
      static_cast<long long>(gx) == static_cast<long long>(n) * g.tiles_y * g.tiles_x &&
      gy == (oc + bn - 1) / bn && smem == mma_smem(ph, pw, g.ps, bn, g.ws, ksteps);
  if (!ok) return cudaErrorInvalidValue;
  g.by_cpp = FastDiv(gs * kChunk / g.vx);
  g.by_pw = FastDiv(pw);
  g.by_gs = FastDiv(gs);
  g.by_kw = FastDiv(g.tkw);
  typename Ep::Out* out = static_cast<typename Ep::Out*>(out_v);
  const dim3 grid(gx, gy);
  const int mi = th * tw / 64;
  switch (3 * (mi / 4) + nt) {  // (MI 2 or 4, NJ 1, 2 or 4)
    case 0: return launch_mma_tile<2, 1>(grid, smem, s, x, w, out, g, ep);
    case 1: return launch_mma_tile<2, 2>(grid, smem, s, x, w, out, g, ep);
    case 2: return launch_mma_tile<2, 4>(grid, smem, s, x, w, out, g, ep);
    case 3: return launch_mma_tile<4, 1>(grid, smem, s, x, w, out, g, ep);
    case 4: return launch_mma_tile<4, 2>(grid, smem, s, x, w, out, g, ep);
    case 5: return launch_mma_tile<4, 4>(grid, smem, s, x, w, out, g, ep);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace band
