// Int8 matmul with a fused requant epilogue on Hopper's tensor cores: the
// exact TFLite requant (kernel B1) and the float32 requant of fast numerics
// (kernel B4).
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
// function, not the Pallas blocks: the TPU kernel took M and N in tiles of
// 256 with the whole K resident and had no w_zp term; this one takes any
// shape, the weight zero point of uint8-era models and uint8 outputs.
//
// What bounds it on the H100.  MobileNetV2's GEMMs at batch 1 are small
// (M = 1..12544 pixels, N and K = 16..1280 channels): 0.1-50 MOPs over a
// few hundred KB each, so the int8 tensor-core rate (1,979 TOPS) and the
// memory rate (3.35 TB/s) both allow a few microseconds per call.  What
// sets the time is latency: how many SMs a call occupies and how many
// dependent round trips to memory each of them makes.
//
// The design, point by point against the __dp4a tile loop it replaces:
//  1. Blocks and K chains.  The output tile and a split of K are chosen per
//     shape in Python (qmatmul.py gemm_plan) from three instances of one
//     template, 32 columns wide: 128 rows (4 warps) for tall matrices, 32
//     rows (2 warps), and 16 rows (1 warp) for M <= 16.  When the tiles
//     alone give fewer than 33 blocks (a quarter of the SMs) and K has 6
//     steps of 32 bytes or more, K is split over up to 8 blocks of one
//     thread-block cluster (grid z, cluster dims (1, 1, splits)), about 2
//     steps each.  Each block owns a share of the tile's rows; the others
//     write their int32 partials of those rows into its shared memory
//     (distributed shared memory), and after one cluster barrier it adds
//     them to its own and runs the epilogue on its share.  One launch per
//     call, no workspace, no second kernel.
//     Split-K does not change a byte: each partial is an int32 sum of int8
//     products, and the partials, the row-sum term and the bias are added
//     in uint32, i.e. modulo 2^32.  Addition modulo 2^32 is associative and
//     commutative, so any slicing and any order of the adds gives the low
//     32 bits of the exact sum, which is what the plain version computes
//     (the int32 wrap of an exact float64 sum).  Within one slice the
//     tensor core's int32 accumulation is exact while |sum| < 2^31; with
//     |a * b| <= 2^14 that holds for any slice shorter than 2^17 bytes of K.
//  2. Loads.  cp.async copies A ([BM, SK]) and B ([SK, BN], the prepared
//     [K, N] layout, unchanged) into a ring of 3-4 shared-memory stages of
//     SK = 128 bytes of K (64 for the 128-row tile), so up to 384 bytes of
//     K are in flight during the MMAs of one stage.  (With 32-byte stages
//     each K step cost ~0.35 us of load time whatever the ring's depth, 3
//     to 8 stages; see PERF.md.)  The copy width is 16 bytes where the row
//     stride (K for A, N for B) and the base allow it, else 8 or 4; a
//     ragged stride or a misaligned base takes plain byte loads.  Copies
//     past M, N or the slice's end in K fill zeros.  (TMA
//     wants 16-byte-multiple global strides; MobileNetV2's K = 24, N = 24
//     and N = 1000 are not, so it is not used.)
//  3. Tensor cores.  mma.sync.m16n8k32 s8 x s8 -> s32.  Its B fragment is
//     K-contiguous per column, and B is N-contiguous in shared memory.
//     The warp's 32 columns are permuted so that fragment column g of
//     8-column tile j is column 4g + j: a thread then reads one 32-bit word
//     (columns 4g..4g+3) from each of four consecutive K rows and a 4x4
//     byte transpose (__byte_perm) yields its B registers of all four tiles.
//     The same permutation leaves each thread 8 consecutive output columns
//     of a row.  rowsum(A), which w_zp multiplies, is one more MMA per step
//     against an all-ones B fragment, issued only when w_zp != 0.
//  4. Epilogue.  Each thread loads the bias and multipliers of its 8
//     columns once, into registers, while its first K steps are in flight,
//     and writes its 8 output bytes of a row with one 8-byte store (byte
//     stores on a ragged N).  The arithmetic is requant.cuh's Epilogue /
//     FastEpilogue, shared with B2 and B3.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma.cuh"
#include "requant.cuh"

namespace band {

namespace cg = cooperative_groups;

constexpr int kStep = 32;       // K bytes of one MMA step
constexpr int kSmemLimit = 48 * 1024;  // without the opt-in attribute
constexpr int kMaxSplits = 8;   // portable cluster size

// A block of W warps stacked along M computes (16 MI W) x 32 outputs, each
// warp (16 MI) x 32.  One pipeline stage holds SK bytes of K (SK / 32 MMA
// steps).
template <int W, int MI, int SK>
struct Tile {
  static constexpr int kThreads = 32 * W;
  static constexpr int kBM = 16 * MI * W;
  static constexpr int kBN = 32;
  // shared rows padded by 16 bytes: conflict-free fragment reads
  static constexpr int kARow = SK + 16;
  static constexpr int kBRow = kBN + 16;
  static constexpr int kAStage = kBM * kARow;
  static constexpr int kStageBytes = kAStage + SK * kBRow;
  // cp.async ring depth: 4, or what shared memory allows
  static constexpr int kStages =
      kSmemLimit / kStageBytes < 4 ? kSmemLimit / kStageBytes : 4;
  // output rows of 8 columns that one thread holds
  static constexpr int kUnits = 2 * MI;
  static constexpr int kPipe = kStages * kStageBytes;
  // Split-K partials that other blocks push to this one, after the
  // stages: 8 sums and one row sum per slot and thread.  A block reduces
  // the units u with u % splits == its rank; slot (u / splits) * splits +
  // q holds block q's partial of unit u.
  static constexpr int slots() {
    int most = 0;
    for (int s = 1; s <= kMaxSplits; ++s) {
      const int n = s * ((kUnits + s - 1) / s);
      most = n > most ? n : most;
    }
    return most;
  }
  static constexpr int kSlots = slots();
  static constexpr int kPart = kSlots * kThreads * 9 * 4;
  static_assert(SK % kStep == 0 && kStages >= 3 && kPipe <= kSmemLimit,
                "tile too large");
  static_assert(kPipe + kPart <= 227 * 1024, "split-K partials too large");
};

// Barriers of the blocks of a cluster (all threads of each block).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct Operands {
  const int8_t* a;  // [M, K]
  const int8_t* b;  // [K, N]
  int M, N, K;
  int va, vb;       // copy widths of A and B rows: 16, 8, 4 or 1
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) x bytes [c0, c0 + WIDTH) of a row-major int8
// matrix (row stride `stride`) into shared memory (row stride DST); bytes
// at or past row nrows or column ncols read 0.  V bytes per copy: 16, 8
// or 4 through cp.async, 1 through plain loads.  ncols, stride and the
// base are multiples of V, so a copy lies wholly inside or wholly outside.
template <int V, int ROWS, int WIDTH, int DST, int THREADS>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const int8_t* src,
                                          int stride, int r0, int nrows,
                                          int c0, int ncols, int tid) {
  constexpr int kPerRow = WIDTH / V;
  constexpr int kCopies = ROWS * kPerRow;
  constexpr int kIters = (kCopies + THREADS - 1) / THREADS;
  // unrolled for cp.async; the byte copies (misaligned or ragged rows)
  // stay a loop
#pragma unroll(V == 1 ? 1 : kIters)
  for (int q = 0; q < kIters; ++q) {
    const int i = tid + q * THREADS;
    if (kCopies % THREADS != 0 && i >= kCopies) break;
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * V;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    const int8_t* s =
        ok ? src + static_cast<size_t>(r0 + r) * stride + c0 + c : src;
    uint8_t* d = dst + r * DST + c;
    if constexpr (V == 1) {
      *d = ok ? static_cast<uint8_t>(*s) : 0;
    } else {
      cp_async<V>(d, s, ok);
    }
  }
}

// One stage: A [m0.., k0..k0+SK) and B [k0..k0+SK, n0..), zero at and
// past K byte kend (the end of this block's slice of K).
template <class T, int SK>
__device__ __forceinline__ void load_stage(uint8_t* stage, const Operands& op,
                                           int m0, int n0, int k0, int kend,
                                           int tid) {
  uint8_t* as = stage;
  uint8_t* bs = stage + T::kAStage;
  constexpr int BM = T::kBM, BN = T::kBN, AR = T::kARow, BR = T::kBRow,
                TH = T::kThreads;
  switch (op.va) {
    case 16:
      copy_tile<16, BM, SK, AR, TH>(as, op.a, op.K, m0, op.M, k0, kend, tid);
      break;
    case 8:
      copy_tile<8, BM, SK, AR, TH>(as, op.a, op.K, m0, op.M, k0, kend, tid);
      break;
    case 4:
      copy_tile<4, BM, SK, AR, TH>(as, op.a, op.K, m0, op.M, k0, kend, tid);
      break;
    default:
      copy_tile<1, BM, SK, AR, TH>(as, op.a, op.K, m0, op.M, k0, kend, tid);
  }
  switch (op.vb) {
    case 16:
      copy_tile<16, SK, BN, BR, TH>(bs, op.b, op.N, k0, kend, n0, op.N, tid);
      break;
    case 8:
      copy_tile<8, SK, BN, BR, TH>(bs, op.b, op.N, k0, kend, n0, op.N, tid);
      break;
    case 4:
      copy_tile<4, SK, BN, BR, TH>(bs, op.b, op.N, k0, kend, n0, op.N, tid);
      break;
    default:
      copy_tile<1, SK, BN, BR, TH>(bs, op.b, op.N, k0, kend, n0, op.N, tid);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Requantize 8 sums of row m, columns n..n+7, and store the bytes.
template <class Ep>
__device__ __forceinline__ void store_row8(
    const Ep& ep, const typename Ep::Params (&p)[8], const int32_t (&v)[8],
    int32_t wsum, int8_t* out, int m, int n, int M, int N, bool vec) {
  if (m >= M || n >= N) return;
  int8_t* o = out + static_cast<size_t>(m) * N + n;
  if (vec) {  // N % 8 == 0, so n + 8 <= N; o is 8-byte aligned
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      ep.apply(v[e], wsum, p[e])))
                  << (8 * (e % 4));
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (n + e < N) o[e] = ep.apply(v[e], wsum, p[e]);
  }
}

// out = ep(A . B, rowsum(A)).  Block (x, y, z): rows x * BM, columns
// y * BN, K steps [z * kt_per, (z + 1) * kt_per) of 32 bytes; with
// splits > 1 the z blocks of a cluster add their partials before the
// epilogue.
template <int W, int MI, int SK, class Ep>
__global__ void __launch_bounds__(32 * W)
    qmatmul_kernel(Operands op, int8_t* __restrict__ out, int kt_per,
                   int splits, bool vec_out, Ep ep) {
  using T = Tile<W, MI, SK>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row / column group
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.x * T::kBM;
  const int n0 = blockIdx.y * T::kBN;
  // this block's slice of K, in bytes, and its stages
  const int kbeg = blockIdx.z * kt_per * kStep;
  const int kend = kbeg + kt_per * kStep < op.K ? kbeg + kt_per * kStep : op.K;
  const int ns = kend > kbeg ? (kend - kbeg + SK - 1) / SK : 0;
  const bool rowsum = ep.w_zp != 0;
  // a cluster's blocks may write each other's shared memory only once all
  // have started: arrive now, wait before the first such write
  if (splits > 1) cluster_arrive_relaxed();
  // this thread's 8 output columns and their requant parameters, loaded
  // while the first stages are in flight
  const int nc = n0 + 8 * t;
  typename Ep::Params prm[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    prm[e] = ep.params(nc + e < op.N ? nc + e : op.N - 1);

  int32_t acc[MI][4][4];
  int32_t rs[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rs[mi][r] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][j][r] = 0;
    }

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < ns)
      load_stage<T, SK>(smem + s * T::kStageBytes, op, m0, n0, kbeg + s * SK,
                        kend, tid);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    const int nxt = i + T::kStages - 1;
    if (nxt < ns)
      load_stage<T, SK>(smem + (nxt % T::kStages) * T::kStageBytes, op, m0,
                        n0, kbeg + nxt * SK, kend, tid);
    cp_async_commit();

    const uint8_t* as = smem + (i % T::kStages) * T::kStageBytes;
    const uint8_t* bs = as + T::kAStage;
#pragma unroll
    for (int sub = 0; sub < SK / kStep; ++sub) {
      if (kbeg + i * SK + sub * kStep >= kend) break;
      // B fragments of the warp's four 8-column tiles (permuted columns)
      uint32_t bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* p = bs + (kStep * sub + 16 * h + 4 * t) * T::kBRow +
                           4 * g;
        uint32_t o[4];
        transpose4x4(ld32(p), ld32(p + T::kBRow), ld32(p + 2 * T::kBRow),
                     ld32(p + 3 * T::kBRow), o);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j][h] = o[j];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint8_t* p = as + (16 * (MI * warp + mi) + g) * T::kARow +
                           kStep * sub + 4 * t;
        const uint32_t a[4] = {ld32(p), ld32(p + 8 * T::kARow), ld32(p + 16),
                               ld32(p + 8 * T::kARow + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mi][j], a, bf[j][0], bf[j][1]);
        if (rowsum) mma_s8(rs[mi], a, 0x01010101u, 0x01010101u);
      }
    }
  }
  cp_async_wait<0>();

  // unit u = (mi, h): row 16 (MI warp + mi) + 8 h + g; sums of column
  // nc + e in acc[mi][e % 4][2 h + e / 4], its row sum in rs[mi][2 h]
  const int mrow = m0 + 16 * MI * warp + g;

  if (splits == 1) {
#pragma unroll
    for (int u = 0; u < T::kUnits; ++u) {
      const int mi = u / 2, h = u % 2;
      int32_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = acc[mi][e % 4][2 * h + e / 4];
      store_row8(ep, prm, v, rs[mi][2 * h], out, mrow + 16 * mi + 8 * h, nc,
                 op.M, op.N, vec_out);
    }
    return;
  }

  // Split K: push each unit's partial to the block that reduces it, then
  // one cluster barrier; after it no block touches another's memory, so
  // a block may leave as soon as its own units are stored.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int32_t* part = reinterpret_cast<int32_t*>(smem + T::kPipe);
  int32_t* rsp = part + T::kSlots * T::kThreads * 8;  // row sums
  cluster_wait();  // every block has started
#pragma unroll
  for (int u = 0; u < T::kUnits; ++u) {
    const int owner = u % splits;
    if (owner == rank) continue;  // reduced here, from registers
    const int mi = u / 2, h = u % 2;
    const int at = ((u / splits) * splits + rank) * T::kThreads + tid;
    int4* d = reinterpret_cast<int4*>(cluster.map_shared_rank(part, owner) +
                                      at * 8);
    d[0] = make_int4(acc[mi][0][2 * h], acc[mi][1][2 * h], acc[mi][2][2 * h],
                     acc[mi][3][2 * h]);
    d[1] = make_int4(acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                     acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]);
    if (rowsum) cluster.map_shared_rank(rsp, owner)[at] = rs[mi][2 * h];
  }
  cluster.sync();  // every push has landed
#pragma unroll
  for (int u = 0; u < T::kUnits; ++u) {
    if (u % splits != rank) continue;
    const int mi = u / 2, h = u % 2;
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = static_cast<uint32_t>(acc[mi][e % 4][2 * h + e / 4]);
    uint32_t ws = static_cast<uint32_t>(rs[mi][2 * h]);
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q >= splits || q == rank) continue;
      const int at = ((u / splits) * splits + q) * T::kThreads + tid;
      const int4* src = reinterpret_cast<const int4*>(part + at * 8);
      const int4 x = src[0], y = src[1];
      v[0] += static_cast<uint32_t>(x.x);
      v[1] += static_cast<uint32_t>(x.y);
      v[2] += static_cast<uint32_t>(x.z);
      v[3] += static_cast<uint32_t>(x.w);
      v[4] += static_cast<uint32_t>(y.x);
      v[5] += static_cast<uint32_t>(y.y);
      v[6] += static_cast<uint32_t>(y.z);
      v[7] += static_cast<uint32_t>(y.w);
      if (rowsum) ws += static_cast<uint32_t>(rsp[at]);
    }
    int32_t sums[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sums[e] = static_cast<int32_t>(v[e]);
    store_row8(ep, prm, sums, static_cast<int32_t>(ws), out,
               mrow + 16 * mi + 8 * h, nc, op.M, op.N, vec_out);
  }
}

template <int W, int MI, int SK, class Ep>
cudaError_t launch_tile(const Operands& op, int8_t* out, int kt_per,
                        int splits, const Ep& ep, cudaStream_t s) {
  using T = Tile<W, MI, SK>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((op.M + T::kBM - 1) / T::kBM,
                     (op.N + T::kBN - 1) / T::kBN, splits);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = splits > 1 ? T::kPipe + T::kPart : T::kPipe;
  cfg.stream = s;
  if (cfg.dynamicSmemBytes > kSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmatmul_kernel<W, MI, SK, Ep>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cfg.dynamicSmemBytes));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const bool vec_out =
      op.N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return cudaLaunchKernelEx(&cfg, qmatmul_kernel<W, MI, SK, Ep>, op, out,
                            kt_per, splits, vec_out, ep);
}

// The widest copy (16, 8 or 4 bytes) that a row stride and a base allow,
// else 1.
inline int copy_width(const void* p, int stride) {
  for (int v = 16; v >= 4; v /= 2)
    if (stride % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0) return v;
  return 1;
}

// tile: the index of qmatmul.py's TILES (the cases below, in that order)
template <class Ep>
int launch_qmatmul(const void* a, const void* b, void* out, int M, int N,
                   int K, int tile, int splits, int kt_per, const Ep& ep,
                   void* stream) {
  const int ktiles = (K + kStep - 1) / kStep;
  if (splits < 1 || splits > kMaxSplits || kt_per < 0 ||
      static_cast<long long>(splits) * kt_per < ktiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands op{static_cast<const int8_t*>(a),
                    static_cast<const int8_t*>(b), M, N, K,
                    copy_width(a, K), copy_width(b, N)};
  int8_t* o = static_cast<int8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (tile) {
    case 0: e = launch_tile<4, 2, 64>(op, o, kt_per, splits, ep, s); break;
    case 1: e = launch_tile<2, 1, 128>(op, o, kt_per, splits, ep, s); break;
    case 2: e = launch_tile<1, 1, 128>(op, o, kt_per, splits, ep, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace band

extern "C" int band_qmatmul_exact(const void* a, const void* b,
                                  const void* bias, const void* qm,
                                  const void* shift, void* out, int M, int N,
                                  int K, int qstride, int w_zp, int out_zp,
                                  int qmin, int qmax, int rounding, int tile,
                                  int splits, int kt_per, void* stream) {
  using namespace band;
  const Epilogue ep{static_cast<const int32_t*>(bias),
                    static_cast<const int32_t*>(qm),
                    static_cast<const int32_t*>(shift),
                    qstride, w_zp, out_zp, qmin, qmax, rounding};
  return launch_qmatmul(a, b, out, M, N, K, tile, splits, kt_per, ep, stream);
}

extern "C" int band_qmatmul_fast(const void* a, const void* b,
                                 const void* bias, const void* mult,
                                 void* out, int M, int N, int K, int mstride,
                                 int w_zp, int out_zp, int qmin, int qmax,
                                 int tile, int splits, int kt_per,
                                 void* stream) {
  using namespace band;
  const FastEpilogue ep{static_cast<const int32_t*>(bias),
                        static_cast<const float*>(mult), mstride, w_zp,
                        out_zp, qmin, qmax};
  return launch_qmatmul(a, b, out, M, N, K, tile, splits, kt_per, ep, stream);
}
