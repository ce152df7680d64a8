"""The int8 conv's launch plan (``conv_plan``: the direct kernel and its
tile or the mma branch and its tiles; qgemm.cuh's loop only when forced)
and the block and thread arithmetic of both kernels, on the CPU.

The CUDA kernels (csrc/qconv.cu, csrc/qconv_mma.cuh) run only on the
card, where tests/test_torch_cuda.py and chip_smoke.py hold them
byte-equal to the plain version.  Here numpy replays what they do.  The
direct kernel, block by block and thread by thread: the weights staged as
dp4a words (zero bytes past Ci), the input patch staged with x_zp outside
the image and zero pad bytes, each thread's P pixels x CV channels of
__dp4a over the tap words, the window sum as a dp4a with 0x01010101, and
the tile edges.  The mma branch, block by block: the patch of each
channel group with its odd 16-byte pixel stride, the weights transposed
to [column][K], the chunk table (chunk -> tap, slab -> patch offset),
each A row's patch address, the odd chunk's pad, the window sum's B
fragment, each group's sums (held within int32) added modulo 2^32, and
the gathering block that stages one tap at a time.  The replays are
held byte-equal (tolerance 0) to band_tpu's Pallas kernel in interpret
mode (stride 1 on a zero-point-padded input), to band_tpu's lowering of
CONV_2D (conv_mode="f32_split") at stride 2, and to the plain version."""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import band_tpu.ir.graph as JG
import band_tpu.tflite.schema as JS
from band_tpu.backend.program import build_program as jbuild
from band_tpu.ops import lowerings as JL
from band_tpu.ops import quant as JQ
from band_tpu.ops.pallas.qconv import qconv2d_exact as pallas_qconv
from band_tpu_torch.backend.program import build_program as tbuild
import band_tpu_torch.ir.graph as TG
import band_tpu_torch.tflite.schema as TS
from band_tpu_torch.ops import quant as Q
from band_tpu_torch.ops.kernels import qconv as QC
from band_tpu_torch.ops.kernels.sweep_conv import conv_shapes, out_size

SRC = os.path.join(os.path.dirname(QC.__file__), "csrc", "qconv.cu")
MMA_SRC = os.path.join(os.path.dirname(SRC), "qconv_mma.cuh")
ROUNDINGS = ["single", "double", "ruy"]


@pytest.fixture
def one_thread():
    """The capture runs a whole model in plain PyTorch: on one thread it
    takes seconds, where test workers that share the cores would each
    start a thread per core and slow one another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _plan(geom, align=16):
    n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
    return QC.conv_plan(n, *out_size(geom), ci, oc, kh, kw, stride, dil,
                        align)


def _written(plan, n, oh, ow, oc):
    """How often the plan's grid writes each output (n, oy, ox, c): every
    thread of every block, indexed as the kernel indexes them."""
    count = np.zeros((n, oh, ow, oc), np.int64)
    cv, p = QC.DIRECT_VARIANTS[plan.variant]
    th, tw = plan.tile
    groups = oc // cv
    npt = plan.threads // groups
    assert npt * p == th * tw and plan.threads % groups == 0, plan
    tid = np.arange(plan.threads)
    cg, pthr = tid % groups, tid // groups
    gx, gy, gz = plan.grid
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                for j in range(p):
                    pix = pthr + j * npt
                    ty = pix // tw
                    oy, ox = by * th + ty, bx * tw + pix - ty * tw
                    keep = (oy < oh) & (ox < ow)
                    for c in range(cv):
                        np.add.at(count, (bz, oy[keep], ox[keep],
                                          cg[keep] * cv + c), 1)
    return count


def _mma_written_once(plan, n, oh, ow, oc):
    """An mma plan's grid writes each output (n, oy, ox, c) exactly once:
    blockIdx.x decoded as the kernel decodes it ((image, tile row, tile
    column), tile column fastest) covers every pixel tile of every image
    once, the tiles cover the output rows and columns once, a block's
    threads cover its th x tw pixels and BN columns once (rows gq, gq + 8
    of each m16 tile, columns 2 tq, 2 tq + 1 of each n8 tile) and the
    column tiles on grid y cover Oc once; the grid within its bounds."""
    th, tw = plan.tile
    bn = QC.MMA_NTILES[plan.variant]
    tiles_x, tiles_y = -(-ow // tw), -(-oh // th)
    gx, gy, gz = plan.grid
    assert (gx, gy, gz) == (n * tiles_y * tiles_x, -(-oc // bn), 1), plan
    assert gx <= QC.MAX_GRID_X and gy <= QC.MAX_GRID_YZ
    b = np.arange(gx)
    bx, rest = b % tiles_x, b // tiles_x
    by, img = rest % tiles_y, rest // tiles_y
    assert len(set(zip(img.tolist(), by.tolist(), bx.tolist()))) == gx
    assert img.max() == n - 1
    rows = (np.arange(tiles_y)[:, None] * th + np.arange(th)).ravel()
    cols = (np.arange(tiles_x)[:, None] * tw + np.arange(tw)).ravel()
    for idx, size in ((rows, oh), (cols, ow)):
        kept = idx[idx < size]
        assert np.array_equal(np.sort(kept), np.arange(size))
    # a block: 4 warps x (MI m16 tiles x rows gq, gq + 8) x (NJ n8 tiles x
    # columns 2 tq, 2 tq + 1)
    mi_n, nj_n = th * tw // 64, bn // 8
    lane = np.arange(32)
    gq, tq = lane >> 2, lane & 3
    m = np.array([16 * (mi_n * warp + mi) + gq + 8 * h
                  for warp in range(4) for mi in range(mi_n)
                  for h in range(2)])
    c = np.array([8 * j + 2 * tq + e for j in range(nj_n) for e in range(2)])
    count = np.zeros((th * tw, bn), np.int64)
    np.add.at(count, (m[:, :, None], c.T[None, :, :]), 1)
    assert count.min() == 1 and count.max() == 1
    cols_c = (np.arange(gy)[:, None] * bn + np.arange(bn)).ravel()
    assert np.array_equal(np.sort(cols_c[cols_c < oc]), np.arange(oc))


# --------------------------------------------------------------------------
# the plan on every B2 call of the slice models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model,batch,calls", [
    (m, b, c) for m, c in (("mobilenet_v2_int8", 1), ("effnetlite_int8", 1),
                           ("resnetish_int8", 5), ("fc_int8", 1))
    for b in (1, 8)])
def test_plan_for_every_b2_call(model, batch, calls, one_thread):
    """Captured from the port's program run on the CPU: every B2 call of
    these models (stems with Ci = 3, 3x3 convs with Ci = 8 and 16, Oc 16
    and 32) takes the direct kernel, 8 channels and 1 or 2 pixels to a
    thread, and its grid writes each output exactly once."""
    shapes = conv_shapes(batch, (model,))
    assert sum(shapes.values()) == calls
    for geom in shapes:
        n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
        assert ci in (3, 8, 16) and oc <= QC.MAX_OC, geom
        plan = _plan(geom)
        assert plan.variant >= 0 and QC.fits(plan, ci, oc), (geom, plan)
        cv, p = QC.DIRECT_VARIANTS[plan.variant]
        assert cv == QC.PLAN_CV and plan.threads <= QC.PLAN_THREADS
        assert (p == 2) == (plan.blocks >= QC.PAIR_BLOCKS) and p <= 2, plan
        count = _written(plan, n, *out_size(geom), oc)
        assert count.min() == 1 and count.max() == 1, (geom, plan)


@pytest.mark.parametrize("geom,branch", [
    # (n, h, w, ci, oc, kh, kw, stride, dilation, padding)
    ((2, 17, 15, 8, 24, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), "direct"),
    ((1, 19, 19, 16, 70, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))), "mma"),
    ((2, 12, 12, 5, 9, 5, 5, (1, 2), (1, 1), ((2, 2), (1, 2))), "mma"),
    ((1, 9, 9, 4, 128, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), "mma"),
    ((1, 9, 9, 512, 64, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), "mma"),
    ((1, 30, 30, 64, 64, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))), "mma"),
    ((1, 30, 30, 16, 64, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))), "direct"),
    ((2, 9, 9, 12, 16, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), "direct"),
    ((3, 7, 9, 1, 8, 5, 3, (2, 1), (1, 2), ((2, 2), (2, 2))), "direct"),
    ((1, 1, 300, 3, 16, 1, 3, (1, 1), (1, 1), ((0, 0), (1, 1))), "direct"),
    ((1, 360, 640, 12, 12, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), "mma"),
    ((1, 360, 640, 56, 4, 5, 5, (1, 1), (1, 1), ((2, 2), (2, 2))), "mma"),
    ((1, 9, 9, 16384, 8, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), "mma"),
    ((1, 130, 130, 32, 16, 3, 3, (1, 1), (60, 60), ((60, 60), (60, 60))),
     "gather"),
    ((1, 130, 130, 32, 16, 3, 3, (1, 1), (50, 50), ((50, 50), (50, 50))),
     "mma"),
    ((1, 130, 130, 32, 32, 3, 3, (1, 1), (54, 54), ((54, 54), (54, 54))),
     "mma"),
])
def test_plan_branches(geom, branch):
    """Ci above 16, Oc not a multiple of 8 or above 64, weights off an
    8-byte boundary, or a patch and weights beyond 48 KB of shared
    memory, take the general branch, the mma kernel: with K of MAX_MMA_K
    bytes and more in channel groups each below it, and with a halo too
    large for shared memory (3x3 taps 60 apart) as a gathering block,
    after a narrower N tile than Oc asks for (taps 54 apart, Oc 32: 8
    columns); never qgemm.cuh's loop.  The rest take the direct kernel.  Each grid
    writes each output exactly once."""
    n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
    plan = _plan(geom)
    assert (plan.branch, plan.gather) == (
        ("mma", True) if branch == "gather" else (branch, False)), plan
    general = QC.general_plan(n, *out_size(geom), ci, oc, kh, kw, stride,
                              dil)
    for align in (1, 2, 4):
        assert _plan(geom, align) == general
    if branch == "direct":
        assert QC.fits(plan, ci, oc)
        count = _written(plan, n, *out_size(geom), oc)
        assert count.min() == 1 and count.max() == 1, plan
    else:
        assert plan == general
    if plan.branch == "mma":
        assert QC.mma_fits(plan, ci, kh, kw), plan
        assert plan.smem <= (QC.MAX_SMEM_OPTIN if dil[0] in (50, 54) else
                             QC.MAX_SMEM), plan
        taps = 1 if plan.gather else kh * kw
        assert 32 * -(-taps * plan.slabs // 2) < QC.MAX_MMA_K
        _mma_written_once(plan, n, *out_size(geom), oc)
    if dil[0] == 54:
        assert QC.MMA_NTILES[plan.variant] == 8 < oc, plan
    if ci == 16384:
        # K above MAX_MMA_K: channel groups, each below it
        assert kh * kw * ci >= QC.MAX_MMA_K and plan.slabs < 1024, plan


@pytest.mark.parametrize("variant", range(len(QC.DIRECT_VARIANTS)))
@pytest.mark.parametrize("th,tw", [(1, 8), (2, 16), (4, 8), (3, 5)])
def test_every_variant_covers_ragged_tiles(variant, th, tw):
    """Each direct variant, forced onto tiles that do not divide the
    output, writes every output exactly once (where P divides the tile)."""
    n, oh, ow, oc = 2, 7, 11, 32
    plan = QC.direct_plan(variant, n, oh, ow, 3, oc, 3, 3, (2, 2), (1, 1),
                          th, tw)
    if not QC.fits(plan, 3, oc):
        assert (th * tw) % QC.DIRECT_VARIANTS[variant][1] != 0
        return
    count = _written(plan, n, oh, ow, oc)
    assert count.min() == 1 and count.max() == 1, plan


def test_variants_and_bounds_match_the_kernel_source():
    src = open(SRC).read()
    cases = re.findall(r"case (\d+): qconv_direct_kernel<(\d+), (\d+), WP, KS, "
                       r"WZP, Ep>", src)
    assert [int(c[0]) for c in cases] == list(range(len(QC.DIRECT_VARIANTS)))
    assert [(int(c[1]), int(c[2])) for c in cases] == list(
        QC.DIRECT_VARIANTS)
    assert re.search(r"constexpr int kDirectMaxThreads = (\d+);",
                     src).group(1) == str(QC.MAX_THREADS)
    # the words per pixel the launch picks, as direct_words gives them
    for ci in range(1, QC.MAX_DIRECT_CI + 1):
        wp = 1 if ci <= 4 else 2 if ci <= 8 else 4
        assert QC.direct_words(ci) == wp
    assert "if (g.Ci <= 4)\n    return launch_taps<1, WZP>" in src
    assert "if (g.Ci <= 8)\n    return launch_taps<2, WZP>" in src
    assert "if (g.Ci <= 16)\n    return launch_taps<4, WZP>" in src


# --------------------------------------------------------------------------
# the direct kernel, replayed block by block and thread by thread
# --------------------------------------------------------------------------

# lines of csrc/qconv.cu that the replay below follows, statement for
# statement
KERNEL_SOURCE = [
    "m(div == 1 ? 0u : static_cast<uint32_t>((0x100000000ull + div - 1) / div)) {}",
    "return d == 1u ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));",
    "const uint32_t a = __byte_perm(r[0], r[1], 0x5140);",
    "const uint32_t b = __byte_perm(r[0], r[1], 0x7362);",
    "const uint32_t c = __byte_perm(r[2], r[3], 0x5140);",
    "const uint32_t d = __byte_perm(r[2], r[3], 0x7362);",
    "*out = make_uint4(__byte_perm(a, c, 0x5410), __byte_perm(a, c, 0x7632),",
    "__byte_perm(b, d, 0x5410), __byte_perm(b, d, 0x7632));",
    "constexpr int kW = 2;",
    "constexpr int kPix = 4 / WP;",
    "const int octets = g.Oc / 8;",
    "const int nw = g.kh * g.kw * WP * octets;",
    "const int nx = g.ph * g.pw;",
    "uint32_t* s_x = smem + g.kh * g.kw * WP * g.Oc;",
    "const int cg = tid % groups;",
    "const int pthr = tid / groups;",
    "const int npt = nt / groups;",
    "const int8_t zp = static_cast<int8_t>(g.x_zp);",
    "const int iy0 = oy0 * g.sh - g.pt;",
    "const int ix0 = ox0 * g.sw - g.pl;",
    "for (int round = 0; round * kW * nt < nw || round * kPix * nt < nx;",
    "const int rw = tid + round * kW * nt;",
    "const int rx = tid + round * kPix * nt;",
    "const int i = min(rw + k * nt, nw - 1);",
    "const int tq = g.by_oct(i);",
    "const int c = 4 * (tq - t * WP);",
    "wr[k][e] = w8[(min(t * g.Ci + c + e, K - 1) * g.Oc) / 8 + i - tq * octets];",
    "const bool real = c + e < g.Ci;",
    "lo[e] = real ? wr[k][e].x : 0u;",
    "hi[e] = real ? wr[k][e].y : 0u;",
    "uint4* dst = reinterpret_cast<uint4*>(s_w + tq * g.Oc + 8 * (i - tq * octets));",
    "const int i = min(rx + k * nt, nx - 1);",
    "const int py = g.by_pw(i);",
    "const int ix = ix0 + i - py * g.pw;",
    "in[k] = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;",
    "for (int c = 0; c < 4 * WP; ++c) xb[k][c] = p[min(c, g.Ci - 1)];",
    "const int i = rx + k * nt;",
    "v |= byte_at(c >= g.Ci ? 0 : in[k] ? xb[k][c] : zp, e);",
    "if (i < nx) s_x[i * WP + q] = v;",
    "const int pix = pthr + j * npt;",
    "base[j] = (ty * g.sh * g.pw + (pix - ty * g.tw) * g.sw) * WP;",
    "const int kh = KS ? KS : g.kh;",
    "const int xo = (dy * g.dh * g.pw + dx * g.dw) * WP;",
    "const uint32_t* wt = s_w + (dy * kw + dx) * WP * g.Oc + c0;",
    "*reinterpret_cast<const uint4*>(wt + q * g.Oc + 4 * k);",
    "const int xv = static_cast<int>(s_x[base[j] + xo + q]);",
    "acc[j][c] = __dp4a(xv, static_cast<int>(wv[c]), acc[j][c]);",
    "if constexpr (WZP) rs[j] = __dp4a(xv, 0x01010101, rs[j]);",
    "const int ox = ox0 + pix - ty * g.tw;",
    "if (oy >= g.OH || ox >= g.OW) continue;",
    "pk[c / 4] |= byte_at(ep.apply(acc[j][c], rs[j], prm[c]), c % 4);",
    "x_zp, p.th, p.tw, p.ph, p.pw, FastDiv(oc / 8), FastDiv(p.pw)};",
]


def test_knockout_copies_remove_one_phase_each():
    """knockout.py's copies of csrc/qconv.cu (staging, taps, requant
    removed) find their markers in the source and differ from it."""
    from band_tpu_torch.ops.kernels import knockout

    variants = knockout._variants("qconv")
    assert set(variants) == {"whole", "no_stage", "no_taps", "trivial_ep"}
    assert variants["whole"] == open(SRC).read()
    assert len({v for v in variants.values()}) == 4


def test_replay_follows_the_kernel_source():
    src = " ".join((open(SRC).read() + open(MMA_SRC).read()).split())
    for line in KERNEL_SOURCE:
        assert " ".join(line.split()) in src, line


def _fastdiv(n, d):
    """FastDiv of csrc/qconv.cu: n / d as the high word of n * ceil(2^32
    / d) (n itself for d == 1)."""
    if d == 1:
        return np.asarray(n)
    m = np.uint64((2 ** 32 + d - 1) // d)
    return ((np.asarray(n).astype(np.uint64) * m) >> np.uint64(32)).astype(
        np.int64)


def _staged(n_items, per_round, threads):
    """How often the staging rounds store each item: thread tid, round
    and k store item tid + (round * per_round + k) * threads while it is
    below n_items; rounds run while either array has items left (here:
    while this one has, the other's rounds only add out-of-range ones)."""
    count = np.zeros(n_items, np.int64)
    rounds = -(-n_items // (per_round * threads))
    for tid in range(threads):
        for rnd in range(rounds + 2):
            for k in range(per_round):
                i = tid + (rnd * per_round + k) * threads
                if i < n_items:
                    count[i] += 1
    return count


@pytest.mark.parametrize("ci", [1, 3, 5, 8, 12, 16])
@pytest.mark.parametrize("th,tw,threads", [(2, 16, 64), (4, 16, 128),
                                           (1, 8, 16), (8, 16, 256)])
def test_staging_rounds_store_every_item_once(ci, th, tw, threads):
    """The round loop of csrc/qconv.cu's staging (kW weight items of 4
    rows x 8 channels and kPix = 4 / WP patch pixels per thread and
    round) stores every weight item and every patch pixel exactly once,
    for every words-per-pixel instance and block size."""
    wp = QC.direct_words(ci)
    k_w, k_pix = 2, 4 // wp
    for kh, kw, oc, (sh, sw) in ((3, 3, 16, (1, 1)), (3, 3, 32, (2, 2)),
                                 (5, 3, 64, (2, 1))):
        nw = kh * kw * wp * oc // 8
        ph, pw = (th - 1) * sh + kh, (tw - 1) * sw + kw
        assert _staged(nw, k_w, threads).tolist() == [1] * nw
        assert _staged(ph * pw, k_pix, threads).tolist() == [1] * (ph * pw)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 8, 24, 33, 64, 65, 255, 1000,
                               4097])
def test_fastdiv_is_exact(d):
    """Exact for every n the kernel divides (shared-memory word indices
    and patch pixels, below 2^14) and far beyond: n < 2^32 / d."""
    n = np.arange(0, 2 ** 20, dtype=np.int64)
    n = n[n < 2 ** 32 // d]
    np.testing.assert_array_equal(_fastdiv(n, d), n // d)


def _dp4a(a, b, c):
    """__dp4a: the four signed byte products of a and b, added to c."""
    for i in range(4):
        sa = ((np.asarray(a, np.uint32) >> np.uint32(8 * i))
              & np.uint32(0xff)).astype(np.int64)
        sb = ((np.asarray(b, np.uint32) >> np.uint32(8 * i))
              & np.uint32(0xff)).astype(np.int64)
        c = c + ((sa ^ 0x80) - 0x80) * ((sb ^ 0x80) - 0x80)
    return c


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (s >> 4i) & 7 of the eight bytes x (0-3), y (4-7)."""
    x = np.asarray(x, np.uint32)
    y = np.asarray(y, np.uint32)
    src = [(v >> np.uint32(8 * i)) & np.uint32(0xff)
           for v in (x, y) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _words(b):
    """int8 [..., 4] -> uint32 [...], byte 0 lowest (the kernel's word
    assembly from four bytes)."""
    u = b.astype(np.uint8).astype(np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def _byte_at(v, e):
    return (np.asarray(v).astype(np.uint8).astype(np.uint32)
            << np.uint32(8 * e))


def _replay_direct(x, w_km, plan, kh, kw, stride, dilation, padding, x_zp):
    """The raw sums (acc) and window sums (rs) of every output, computed
    as the plan's blocks and threads compute them in csrc/qconv.cu."""
    n, h, wd, ci = x.shape
    oc = w_km.shape[1]
    (sh, sw), (dh, dw) = stride, dilation
    (pt, _), (pl, _) = padding
    oh = QC.conv_out_size(h, kh, sh, dh, sum(padding[0]))
    ow = QC.conv_out_size(wd, kw, sw, dw, sum(padding[1]))
    cv, p = QC.DIRECT_VARIANTS[plan.variant]
    th, tw = plan.tile
    ph, pw = plan.patch
    wp = QC.direct_words(ci)
    nt = plan.threads
    acc = np.zeros((n, oh, ow, oc), np.int64)
    rs = np.zeros((n, oh, ow), np.int64)
    written = np.zeros((n, oh, ow, oc), np.int64)
    # the weights as dp4a words, zero bytes past Ci (the same for every
    # block): an item (tap * WP + word, octet) loads 4 rows of w_km x 8
    # output channels (8 bytes a row, the row clamped below K) and
    # transposes them into 8 words
    octets = oc // 8
    k_rows = kh * kw * ci
    w8 = w_km.reshape(k_rows, octets, 8)
    i = np.arange(kh * kw * wp * octets)
    tq = _fastdiv(i, octets)
    t = tq // wp
    c = 4 * (tq - t * wp)
    octet = i - tq * octets
    s_w = np.zeros(kh * kw * wp * oc, np.uint32)
    rows = []
    for e in range(4):
        v = w8[np.minimum(t * ci + c + e, k_rows - 1), octet]   # [items, 8]
        rows.append(np.where((c + e < ci)[:, None], v, 0).astype(np.int8))
    for half in range(2):
        r = [_words(v[:, 4 * half:4 * half + 4]) for v in rows]
        a = _byte_perm(r[0], r[1], 0x5140)
        b = _byte_perm(r[0], r[1], 0x7362)
        cc = _byte_perm(r[2], r[3], 0x5140)
        d = _byte_perm(r[2], r[3], 0x7362)
        for j, word in enumerate((_byte_perm(a, cc, 0x5410),
                                  _byte_perm(a, cc, 0x7632),
                                  _byte_perm(b, d, 0x5410),
                                  _byte_perm(b, d, 0x7632))):
            s_w[tq * oc + 8 * octet + 4 * half + j] = word
    assert 4 * (s_w.size + ph * pw * wp) == plan.smem
    gx, gy, gz = plan.grid
    groups = oc // cv
    tid = np.arange(nt)
    cg, pthr, npt = tid % groups, tid // groups, nt // groups
    c0 = cg * cv
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                oy0, ox0 = by * th, bx * tw
                # 1. the patch, one pixel per thread and round: its bytes
                # loaded from a clamped address (channel min(c, Ci - 1),
                # pixel (0, 0) outside the image), then x_zp outside the
                # image and 0 in the pad bytes
                iy0, ix0 = oy0 * sh - pt, ox0 * sw - pl
                i = np.arange(ph * pw)
                py = _fastdiv(i, pw)
                iy, ix = iy0 + py, ix0 + i - py * pw
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
                xb = np.zeros((i.size, 4 * wp), np.int8)
                for c in range(4 * wp):
                    loaded = x[bz, np.where(inside, iy, 0),
                               np.where(inside, ix, 0), min(c, ci - 1)]
                    xb[:, c] = (0 if c >= ci else
                                np.where(inside, loaded, np.int8(x_zp)))
                s_x = np.zeros(ph * pw * wp, np.uint32)
                for q in range(wp):
                    s_x[i * wp + q] = _words(xb[:, 4 * q:4 * q + 4])
                # 3. every thread's P pixels x CV channels
                for j in range(p):
                    pix = pthr + j * npt
                    ty = pix // tw
                    base = (ty * sh * pw + (pix - ty * tw) * sw) * wp
                    a = np.zeros((nt, cv), np.int64)
                    r = np.zeros(nt, np.int64)
                    for dy in range(kh):
                        for dx in range(kw):
                            xo = (dy * dh * pw + dx * dw) * wp
                            wt = (dy * kw + dx) * wp * oc + c0
                            for q in range(wp):
                                xv = s_x[base + xo + q]
                                for cc in range(cv):
                                    a[:, cc] = _dp4a(xv, s_w[wt + q * oc
                                                             + cc], a[:, cc])
                                r = _dp4a(xv, 0x01010101, r)
                    # 4. the tile edges
                    oy, ox = oy0 + ty, ox0 + pix - ty * tw
                    keep = (oy < oh) & (ox < ow)
                    for cc in range(cv):
                        sel = (bz, oy[keep], ox[keep], c0[keep] + cc)
                        acc[sel] = a[keep, cc]
                        np.add.at(written, sel, 1)
                    rs[bz, oy[keep], ox[keep]] = r[keep]
    assert written.min() == 1 and written.max() == 1
    return acc, rs


def _accumulate(acc, rs, bias, w_zp):
    """The epilogue's input: acc - w_zp * rs + bias with the int32 wrap."""
    return Q.wrap32(torch.from_numpy(acc - w_zp * rs[..., None]
                                     + bias.astype(np.int64)))


def _forced_plans(geom):
    """conv_plan's own choice, then each direct variant on a small ragged
    tile that makes several blocks and threads."""
    n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
    oh, ow = out_size(geom)
    yield _plan(geom)
    for v in range(len(QC.DIRECT_VARIANTS)):
        p = QC.direct_plan(v, n, oh, ow, ci, oc, kh, kw, stride, dil, 2, 4)
        if QC.fits(p, ci, oc):
            yield p


def _requant_args(out_dtype):
    if out_dtype == np.uint8:
        return dict(out_zp=128, qmin=0, qmax=255)
    return dict(out_zp=-3, qmin=-128, qmax=127)


@pytest.mark.parametrize("ci", [1, 3, 8, 16])
@pytest.mark.parametrize("w_zp,out_dtype", [(0, np.int8), (-5, np.uint8)])
def test_direct_replay_matches_pallas(ci, w_zp, out_dtype):
    """Stride 1 on a zero-point-padded input, the Pallas kernel's own
    form, under every rounding: the replay of the unpadded input with its
    padding read as x_zp, under conv_plan's plan and every variant
    forced, is byte-equal to band_tpu's Pallas kernel (interpret mode)
    and to the plain version."""
    rng = np.random.default_rng(50 + ci)
    n, h, w, oc, kh, kw, x_zp = 2, 6, 7, 16, 3, 3, -9
    pads = ((1, 1), (1, 1))
    x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    x_pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=x_zp)
    wk = rng.integers(-128, 128, (kh * kw * ci, oc)).astype(np.int8)
    m = 30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0) * rng.uniform(0.5, 2, oc)
    qm, sh = JQ.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, oc).astype(np.int32)
    geom = (n, h, w, ci, oc, kh, kw, (1, 1), (1, 1), pads)
    od = Q.torch_dtype(out_dtype)
    rq = _requant_args(out_dtype)
    t = torch.from_numpy
    for plan in _forced_plans(geom):
        acc, rs = _replay_direct(x, wk, plan, kh, kw, (1, 1), (1, 1), pads,
                                 x_zp)
        a = _accumulate(acc, rs, bias, w_zp)
        for rounding in ROUNDINGS:
            got = Q.requantize_exact(a, t(qm).long(), t(sh).long(),
                                     rq["out_zp"], rq["qmin"], rq["qmax"],
                                     od, rounding).numpy()
            want = np.asarray(pallas_qconv(
                jnp.asarray(x_pad), jnp.asarray(wk), jnp.asarray(bias),
                jnp.asarray(qm), jnp.asarray(sh), kh=kh, kw=kw,
                rounding=rounding, w_zp=w_zp, out_dtype=out_dtype,
                tile_h=h, interpret=True, **rq))
            np.testing.assert_array_equal(got, want, err_msg=plan.name)
            plain = QC.qconv2d_plain(
                t(x), t(wk), t(bias), t(qm), t(sh), kh=kh, kw=kw,
                padding=pads, x_zp=x_zp, w_zp=w_zp, rounding=rounding,
                out_dtype=od, **rq).numpy()
            np.testing.assert_array_equal(got, plain, err_msg=plan.name)


def _one_op_graph(G, S, x_shape, x_dtype, wt, w_scales, w_zps, bias,
                  out_shape, stride):
    tt = {np.dtype(np.int8): S.TensorType.INT8,
          np.dtype(np.uint8): S.TensorType.UINT8}

    def qp(scale, zp):
        return G.QuantParams(np.asarray(scale, np.float32),
                             np.asarray(zp, np.int32), 0)

    x_zp = 3 if x_dtype == np.int8 else 131
    out_zp = -5 if x_dtype == np.int8 else 120
    tensors = [
        G.TensorDef(0, "x", tuple(x_shape), tt[np.dtype(x_dtype)],
                    qp([0.05], [x_zp])),
        G.TensorDef(1, "w", tuple(wt.shape), tt[wt.dtype],
                    qp(w_scales, w_zps), data=wt),
        G.TensorDef(2, "b", tuple(bias.shape), S.TensorType.INT32,
                    qp(0.05 * np.asarray(w_scales), np.zeros(len(w_scales))),
                    data=bias),
        G.TensorDef(3, "y", tuple(out_shape), tt[np.dtype(x_dtype)],
                    qp([0.11], [out_zp])),
    ]
    opts = dict(padding="SAME", stride_h=stride, stride_w=stride,
                dilation_h=1, dilation_w=1, activation="RELU")
    op = G.OpNode(0, "CONV_2D", [0, 1, 2], [3], opts)
    return G.Graph("one_conv", tensors, [op], [0], [3])


@pytest.mark.parametrize("ci", [1, 3, 8, 16])
@pytest.mark.parametrize("x_dtype", [np.int8, np.uint8])
def test_direct_replay_matches_band_tpu_lowering(ci, x_dtype):
    """Stride 2, SAME padding, through band_tpu's CONV_2D lowering
    (conv_mode="f32_split"): an int8 model (per-channel weights, w_zp 0,
    int8 out) and a uint8 one (per-tensor weights, w_zp != 0 after the
    shift to int8, uint8 out).  The replay of the kernel, fed the port's
    prepared operands, gives band_tpu's output byte for byte under the
    lowering's rounding, and under all three roundings the lowering's own
    integer conv and window sum requantized by band_tpu's requant."""
    rng = np.random.default_rng(60 + ci)
    n, h, w, oc, stride = 3, 9, 8, 16, 2
    oh, ow = -(-h // stride), -(-w // stride)
    if x_dtype == np.uint8:
        wt = rng.integers(0, 256, (oc, 3, 3, ci)).astype(np.uint8)
        scales, zps = [0.02], [117]
    else:
        wt = rng.integers(-127, 128, (oc, 3, 3, ci)).astype(np.int8)
        scales, zps = list(rng.uniform(0.005, 0.03, oc)), [0] * oc
    bias = rng.integers(-3000, 3000, oc).astype(np.int32)
    info = np.iinfo(x_dtype)
    x = rng.integers(info.min, info.max + 1, (n, h, w, ci)).astype(x_dtype)
    graphs = [_one_op_graph(G, S, (n, h, w, ci), x_dtype, wt, scales, zps,
                            bias, (n, oh, ow, oc), stride)
              for G, S in ((JG, JS), (TG, TS))]
    pj = jbuild(graphs[0], [0], exact=True, conv_mode="f32_split")
    want = np.asarray(jax.jit(pj.make_fn())(pj.params, [x])[0])
    pt = tbuild(graphs[1], [0])
    meta = {k: pt.meta[f"op0/{k}"] for k in ("x_zp", "w_zp", "out_zp",
                                            "qmin", "qmax", "rounding")}
    w_hwio = pt.params["op0/w"]
    wk = np.asarray(w_hwio).reshape(9 * ci, oc)
    xi = x if x_dtype == np.int8 else (x ^ 0x80).view(np.int8)
    pads = _same_pads(h, w, stride)
    assert meta["w_zp"] == (0 if x_dtype == np.int8 else zps[0] - 128)
    qm, sh = (np.asarray(pt.params[f"op0/{k}"]) for k in ("qm", "shift"))
    b = np.asarray(pt.params["op0/bias"])
    geom = (n, h, w, ci, oc, 3, 3, (stride, stride), (1, 1), pads)
    od = Q.torch_dtype(x_dtype)
    t = torch.from_numpy
    # the lowering's integer conv and window sum, on the x_zp-padded input
    ctx = types.SimpleNamespace(conv_mode="f32_split", batch_hint=1)
    xp = np.pad(xi, ((0, 0), pads[0], pads[1], (0, 0)),
                constant_values=meta["x_zp"])
    dn = ("NHWC", "HWIO", "NHWC")
    jconv = np.asarray(JL._int_conv(ctx, jnp.asarray(xp),
                                    jnp.asarray(np.asarray(w_hwio)),
                                    (stride, stride), (1, 1), dn))
    jsum = np.asarray(JL._ones_conv(ctx, jnp.asarray(xp), 3, 3, ci,
                                    (stride, stride), (1, 1), dn))
    jacc = jconv - np.int32(meta["w_zp"]) * jsum + b
    for plan in _forced_plans(geom):
        acc, rs = _replay_direct(xi, wk, plan, 3, 3, (stride, stride),
                                 (1, 1), pads, meta["x_zp"])
        a = _accumulate(acc, rs, b, meta["w_zp"])
        np.testing.assert_array_equal(a.numpy(), jacc.astype(np.int64))
        for rounding in ROUNDINGS:
            got = Q.requantize_exact(a, t(qm).long(), t(sh).long(),
                                     meta["out_zp"], meta["qmin"],
                                     meta["qmax"], od, rounding).numpy()
            ref = np.asarray(JQ.requantize_exact(
                jnp.asarray(jacc), jnp.asarray(qm), jnp.asarray(sh),
                meta["out_zp"], meta["qmin"], meta["qmax"], x_dtype,
                rounding=rounding))
            np.testing.assert_array_equal(got, ref, err_msg=plan.name)
            if rounding == meta["rounding"]:
                np.testing.assert_array_equal(got, want, err_msg=plan.name)


def _same_pads(h, w, stride, k=3):
    def one(size):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return (total // 2, total - total // 2)
    return (one(h), one(w))


@pytest.mark.parametrize("ci", [3, 5])
def test_pad_byte_must_be_zero_for_the_window_sum(ci):
    """The window sum that w_zp multiplies is a dp4a of the patch words
    with 0x01010101: with x_zp in the pad bytes (instead of 0) a border
    output of a ragged Ci would count x_zp once per pad byte, and the
    replayed sums would differ from the plain version's."""
    rng = np.random.default_rng(70 + ci)
    n, h, w, oc, x_zp = 1, 5, 6, 8, -9
    pads = ((1, 1), (1, 1))
    x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    wk = rng.integers(-128, 128, (9 * ci, oc)).astype(np.int8)
    plan = _plan((n, h, w, ci, oc, 3, 3, (1, 1), (1, 1), pads))
    acc, rs = _replay_direct(x, wk, plan, 3, 3, (1, 1), (1, 1), pads, x_zp)
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                constant_values=x_zp)
    want = np.zeros_like(rs)
    for dy in range(3):
        for dx in range(3):
            want += xp[:, dy:dy + h, dx:dx + w, :].sum(-1)
    np.testing.assert_array_equal(rs, want)


def test_general_branch_grid_takes_more_than_65535_row_tiles():
    """The mma branch takes its pixel tiles from blockIdx.x (up to 2^31 -
    1 blocks) and its column tiles from y (65,535 at most): 72 stacked
    FSRCNN frames at 360x640 are 66,240 pixel tiles of 16 x 16.
    qgemm.cuh's loop, behind the forcing hook, does the same with its 64
    x 64 tiles (115,200 row tiles for a b32 window)."""
    src = open(SRC).read()
    mma = open(MMA_SRC).read()
    gemm = open(os.path.join(os.path.dirname(SRC), "qgemm.cuh")).read()
    assert "int b = blockIdx.x;" in mma
    assert "const int n0 = blockIdx.y * BN;" in mma
    assert "const dim3 grid(gx, gy);" in mma
    p = QC.conv_plan(72, 360, 640, 12, 12, 3, 3, (1, 1), (1, 1), 16)
    assert p.branch == "mma" and p.grid == (66240, 1, 1), p
    _mma_written_once(p, 72, 360, 640, 12)
    assert "const dim3 grid((M + kBM - 1) / kBM, (oc + kBN - 1) / kBN);" \
        in src
    assert "const int m0 = blockIdx.x * kBM;" in gemm
    assert "const int n0 = blockIdx.y * kBN;" in gemm
    assert QC.loop_plan(32, 360, 640, 12).grid == (115200, 1, 1)


# --------------------------------------------------------------------------
# the plan on every B2 call of every tests/data model
# --------------------------------------------------------------------------

PLAN_MODELS = ("mobilenet_v2_int8", "effnetlite_int8", "resnetish_int8",
               "fc_int8", "ssd_int8", "ssd_regular_int8", "fsrcnn_x2_int8",
               "fsrcnn_x2_small_int8", "tconv_int8", "cnn_ops_int8")
# conv_plan's choice for FSRCNN's general-branch calls at 360x640, b1
# (sweep_conv.py on the H100; PERF.md)
FSRCNN_PLANS = {(12, 12, 3): "mma/n16/16x16/c16", (56, 4, 5): "mma/n8/16x16/c64"}


def _direct_written_once(plan, n, oh, ow, oc):
    """A direct plan's grid writes each output exactly once: a block's
    threads (channel group tid % groups, pixels pthr + j * npt) cover its
    th x tw pixels and Oc once, and its tiles (grid x columns, y rows, z
    images) cover the output once."""
    cv, p = QC.DIRECT_VARIANTS[plan.variant]
    th, tw = plan.tile
    groups = oc // cv
    npt = plan.threads // groups
    assert npt * p == th * tw
    tid = np.arange(plan.threads)
    count = np.zeros((th * tw, oc), np.int64)
    for j in range(p):
        for c in range(cv):
            np.add.at(count, (tid // groups + j * npt, tid % groups * cv + c),
                      1)
    assert count.min() == 1 and count.max() == 1
    assert plan.grid == (-(-ow // tw), -(-oh // th), n)


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("model", PLAN_MODELS)
def test_plan_for_every_b2_call_of_every_model(model, batch, one_thread):
    """Every B2 call of every tests/data model the port serves (the SSD
    models without their host post-process), FSRCNN at 360x640 and 24x40
    included, at b1, b8 and b32: a direct or mma plan (never the loop)
    whose grid writes each output once, with rows on grid x (the mma
    branch's pixel tiles; the direct kernel's images on z, rows on y,
    each within 65,535) and shared memory within 48 KB; FSRCNN's 3x3
    12 -> 12 convs and union deconv take the sweep's tiles."""
    shapes = conv_shapes(batch, (model,))
    assert shapes
    for geom in shapes:
        n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
        oh, ow = out_size(geom)
        plan = _plan(geom)
        assert plan.branch in ("direct", "mma"), (geom, plan)
        assert plan.smem <= QC.MAX_SMEM, (geom, plan)
        if plan.branch == "direct":
            assert QC.fits(plan, ci, oc), (geom, plan)
            _direct_written_once(plan, n, oh, ow, oc)
        else:
            assert QC.mma_fits(plan, ci, kh, kw), (geom, plan)
            _mma_written_once(plan, n, oh, ow, oc)
        if model == "fsrcnn_x2_int8" and (ci, oc, kh) in FSRCNN_PLANS:
            assert plan.name == FSRCNN_PLANS[ci, oc, kh], plan


# --------------------------------------------------------------------------
# the mma branch (csrc/qconv_mma.cuh), replayed block by block
# --------------------------------------------------------------------------

# lines of csrc/qconv_mma.cuh that the replay below follows, statement for
# statement
MMA_KERNEL_SOURCE = [
    "const int cpp = g.gs * kChunk / V;",
    "const int p = g.by_cpp(i);",
    "const int c = cbase + (i - p * cpp) * V;",
    "const int py = g.by_pw(p);",
    "const int iy = iy0 + py * g.ssh;",
    "const int ix = ix0 + (p - py * g.pw) * g.ssw;",
    "const bool real = c < g.Ci;",
    "uint8_t* dst = s_x + p * g.ps + (c - cbase);",
    "cp_async<V>(dst, src, real);",
    "fill<V>(dst, real ? zp4 : 0u);",
    "const int kb = 4 * (i / Q4);",
    "const int c = kb / kChunk;",
    "const int t = g.by_gs(c);",
    "const int ch = cbase + kChunk * (c - t * g.gs) + kb % kChunk;",
    "const bool ok = c < nchunks && ch + e < g.Ci;",
    "w + static_cast<size_t>((tap0 + t) * g.Ci + ch + e) * g.Oc;",
    "transpose4x4(r[0], r[1], r[2], r[3], o);",
    "*reinterpret_cast<uint32_t*>(s_w + (4 * n4 + q) * g.ws + kb) = o[q];",
    "const int bx = b % g.tiles_x;",
    "const int by = b % g.tiles_y;",
    "const int n = b / g.tiles_y;",
    "const int nchunks = g.tkh * g.tkw * g.gs;",
    "const int ksteps = (nchunks + 1) / 2;",
    "off = (dy * g.dh * g.pw + (t - dy * g.tkw) * g.dw) * g.ps + kChunk * (c - t * g.gs);",
    "const int m = 16 * (MI * warp + mi) + (lane & 7) + 8 * ((lane >> 3) & 1);",
    "(ty * g.psh * g.pw + (m - ty * g.tw) * g.psw) * g.ps;",
    "(8 * (NJ > 1 ? lane >> 4 : 0) + (lane & 7)) * g.ws + kChunk * ((lane >> 3) & 1);",
    "for (int grp = 0; grp < g.taps * g.groups; ++grp) {",
    "const int tg = grp / g.groups;",
    "const int cbase = (grp - tg * g.groups) * g.gs * kChunk;",
    "const int tdy = tg / g.kw;",
    "const int iyg = iy0 + tdy * g.dh;",
    "const int ixg = ix0 + (tg - tdy * g.kw) * g.dw;",
    "stage_weights<BN>(s_w, w, g, n0, tg, cbase, nchunks, 32 * ksteps, tid);",
    "const uint32_t off = static_cast<uint32_t>(s_tab[2 * ks + ahalf]);",
    "ldmatrix_x4(r, bbase + 16 * jp * g.ws + 2 * kChunk * ks);",
    "const uint32_t hi = 2 * ks + 1 < nchunks ? 0x01010101u : 0u;",
    "for (int mi = 0; mi < MI; ++mi) mma_s8(rs[mi], a[mi], 0x01010101u, hi);",
    "if (r < 2) rtot[mi][r] += static_cast<uint32_t>(rs[mi][2 * r]);",
    "tot[mi][j][r] += static_cast<uint32_t>(acc[mi][j][r]), acc[mi][j][r] = 0;",
    "if (r < 2) rs[mi][2 * r] = static_cast<int32_t>(rtot[mi][r]);",
    "acc[mi][j][r] = static_cast<int32_t>(tot[mi][j][r]);",
    "o[col] = ep.apply(acc[mi][j][2 * h + e], rs[mi][2 * h], prm[j][e]);",
    "const bool split = g.taps * g.groups > 1;",
    "return ph * pw * ps + bn * ws + 4 * 2 * ksteps;",
    "g.groups = gs > 0 ? (nslab + gs - 1) / gs : 0;",
    "g.ps = kChunk * (gs | 1);",
    "g.ws = 2 * kChunk * ksteps + kChunk;",
    "g.vx = mma_copy_width(x, ci);",
    "g.taps = gather ? kh * kw : 1;",
    "g.tkh = gather ? 1 : kh;",
    "g.ssh = gather ? sh : 1;",
    "g.psh = gather ? 1 : sh;",
    "const int ksteps = (g.tkh * g.tkw * gs + 1) / 2;",
    "32 * ksteps < (1 << 17) &&",
]


def test_mma_replay_follows_the_kernel_source():
    src = " ".join(open(MMA_SRC).read().split())
    for line in MMA_KERNEL_SOURCE:
        assert " ".join(line.split()) in src, line


def test_mma_instances_match_the_plan():
    """The launch's (MI, NJ) cases are MMA_PIXELS x MMA_NTILES in the
    plan's order, its block has MMA_THREADS threads and K chunks of CHUNK
    bytes, and the shared-memory formula is mma_layout's."""
    src = open(MMA_SRC).read()
    cases = re.findall(r"case (\d+): return launch_mma_tile<(\d+), (\d+)>",
                       src)
    assert [(int(c), 64 * int(mi), 8 * int(nj)) for c, mi, nj in cases] == [
        (3 * i + v, px, bn) for i, px in enumerate(QC.MMA_PIXELS)
        for v, bn in enumerate(QC.MMA_NTILES)]
    assert "constexpr int kMmaWarps = 4;" in src
    assert QC.MMA_THREADS == 4 * 32
    assert "constexpr int kChunk = 16;" in src and QC.CHUNK == 16
    for slabs in range(1, 9):
        ps, ws, ksteps, rest = QC.mma_layout(7, 9, 3, 5, slabs)
        # odd 16-byte units: ldmatrix's 8 rows in 8 bank groups
        assert (ps // 16) % 2 == 1 and (ws // 16) % 2 == 1
        assert ps >= 16 * slabs and ws >= 32 * ksteps
        assert 2 * ksteps >= 15 * slabs
        assert rest == 7 * 9 * ps + 8 * ksteps


def _copy_width(ci, offset):
    """mma_copy_width: the widest of 16, 8, 4 dividing Ci and x's base."""
    return next((v for v in (16, 8, 4) if ci % v == 0 and offset % v == 0), 1)


def _transpose4x4(w0, w1, w2, w3):
    """transpose4x4 of csrc/qconv_mma.cuh on uint32 arrays."""
    l01 = _byte_perm(w0, w1, 0x5140)
    h01 = _byte_perm(w0, w1, 0x7362)
    l23 = _byte_perm(w2, w3, 0x5140)
    h23 = _byte_perm(w2, w3, 0x7362)
    return (_byte_perm(l01, l23, 0x5410), _byte_perm(l01, l23, 0x7632),
            _byte_perm(h01, h23, 0x5410), _byte_perm(h01, h23, 0x7632))


def _replay_mma(x, w_km, plan, kh, kw, stride, dilation, padding, x_zp,
                offset=0):
    """The raw sums (acc) and window sums (rs) of every output, computed
    as the plan's blocks compute them in csrc/qconv_mma.cuh: per group
    (each channel group, and each tap when the block gathers) the patch
    staged V bytes a copy, the weights staged 4 K rows x 4 columns an
    item and transposed, the chunk table; every A row read from the lane
    that loads it (row (lane & 7) + 8 ((lane >> 3) & 1), chunk lane >> 4
    of a step) at its pixel base plus the chunk's offset, every column's
    32 K bytes of a step from the weights; the window sum over every
    chunk but the pad.  Each group's sums must lie within int32 (the
    tensor cores' accumulator); they are added modulo 2^32, as the
    kernel's uint32 totals are.  Shared-memory bytes that no copy writes
    (each pixel's and column's last 16-byte unit) hold 0xA5: they are
    never read."""
    n, h, wd, ci = x.shape
    oc = w_km.shape[1]
    (sh, sw), (dh, dw) = stride, dilation
    (pt, _), (pl, _) = padding
    oh = QC.conv_out_size(h, kh, sh, dh, sum(padding[0]))
    ow = QC.conv_out_size(wd, kw, sw, dw, sum(padding[1]))
    bn = QC.MMA_NTILES[plan.variant]
    th, tw = plan.tile
    ph, pw = plan.patch
    gs = plan.slabs
    nslab = -(-ci // 16)
    groups = -(-nslab // gs)
    # a gathering block: kh * kw tap groups of one tap, its patch one
    # input pixel per output pixel (steps sh, sw); else one tap group
    taps, (tkh, tkw) = (kh * kw, (1, 1)) if plan.gather else (1, (kh, kw))
    (ssh, ssw), (psh, psw) = (((sh, sw), (1, 1)) if plan.gather else
                              ((1, 1), (sh, sw)))
    ps, ws, ksteps, rest = QC.mma_layout(ph, pw, tkh, tkw, gs)
    assert plan.smem == rest + bn * ws
    assert 32 * ksteps < QC.MAX_MMA_K
    nchunks = tkh * tkw * gs
    tiles_x, tiles_y = -(-ow // tw), -(-oh // th)
    v = _copy_width(ci, offset)
    cpp = gs * 16 // v
    # the chunk table
    c = np.arange(2 * ksteps)
    t = _fastdiv(c, gs)
    dy = _fastdiv(t, tkw)
    tab = np.where(c < nchunks,
                   (dy * dh * pw + (t - dy * tkw) * dw) * ps + 16 * (c - t * gs),
                   0)
    # A: row r of an m16 tile, k half hh of a step, comes from lane 16 hh +
    # r, which loads row (lane & 7) + 8 ((lane >> 3) & 1) at chunk lane >> 4
    lane = np.arange(32)
    assert np.array_equal((lane & 7) + 8 * ((lane >> 3) & 1),
                          np.tile(np.arange(16), 2))
    m = np.arange(th * tw)
    ty = m // tw
    abase = (ty * psh * pw + (m - ty * tw) * psw) * ps
    chunk = (2 * np.arange(ksteps)[:, None] + np.arange(2)).ravel()
    addr = (abase[:, None, None] + tab[chunk][None, :, None]
            + np.arange(16)[None, None, :]).reshape(th * tw, -1)
    ones = np.repeat(chunk < nchunks, 16).astype(np.int64)
    acc = np.zeros((n, oh, ow, oc), np.int64)
    rs = np.zeros((n, oh, ow), np.int64)
    written = np.zeros((n, oh, ow, oc), np.int64)
    for b in range(plan.grid[0]):
        bx, bb = b % tiles_x, b // tiles_x
        by, img = bb % tiles_y, bb // tiles_y
        oy0, ox0 = by * th, bx * tw
        iy0, ix0 = oy0 * sh - pt, ox0 * sw - pl
        for yb in range(plan.grid[1]):
            n0 = yb * bn
            a_sum = np.zeros((th * tw, bn), np.int64)
            a_rs = np.zeros(th * tw, np.int64)
            for grp in range(taps * groups):
                tg = grp // groups
                cbase = (grp - tg * groups) * gs * 16
                tdy = tg // kw
                iyg, ixg = iy0 + tdy * dh, ix0 + (tg - tdy * kw) * dw
                # the patch: V bytes a copy
                s_x = np.full(ph * pw * ps, 0xA5, np.uint8)
                i = np.arange(ph * pw * cpp)
                p = _fastdiv(i, cpp)
                cc = cbase + (i - p * cpp) * v
                py = _fastdiv(p, pw)
                iy, ix = iyg + py * ssh, ixg + (p - py * pw) * ssw
                real = cc < ci
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
                for e in range(v):
                    src = x[img, np.clip(iy, 0, h - 1), np.clip(ix, 0, wd - 1),
                            np.minimum(cc + e, ci - 1)]
                    val = np.where(inside, src, np.int8(x_zp))
                    s_x[p * ps + (cc - cbase) + e] = np.where(
                        real, val, 0).astype(np.int8).view(np.uint8)
                # the weights: items of 4 K rows x 4 columns, transposed
                s_w = np.full(bn * ws, 0xA5, np.uint8)
                q4 = bn // 4
                i = np.arange(32 * ksteps // 4 * q4)
                n4, kb = i % q4, 4 * (i // q4)
                ck = kb // 16
                tk = _fastdiv(ck, gs)
                ch = cbase + 16 * (ck - tk * gs) + kb % 16
                col = n0 + 4 * n4
                r = []
                for e in range(4):
                    ok = (ck < nchunks) & (ch + e < ci)
                    row = np.where(ok, (tg + tk) * ci + ch + e, 0)
                    by4 = np.stack([np.where(ok & (col + q < oc),
                                             w_km[row, np.minimum(col + q,
                                                                  oc - 1)], 0)
                                    for q in range(4)], -1)
                    r.append(_words(by4.astype(np.int8)))
                for q, word in enumerate(_transpose4x4(*r)):
                    at = (4 * n4 + q) * ws + kb
                    for e in range(4):
                        s_w[at + e] = (word >> np.uint32(8 * e)) & 0xFF
                a = s_x[addr].view(np.int8).astype(np.int64)
                wt = s_w.reshape(bn, ws)[:, :32 * ksteps].view(np.int8)
                part = a @ wt.astype(np.int64).T
                assert np.abs(part).max() < 2**31  # exact in int32
                a_sum = (a_sum + part) % 2**32
                a_rs = (a_rs + a @ ones) % 2**32
            # the totals as the epilogue reads them: int32
            a_sum = (a_sum + 2**31) % 2**32 - 2**31
            a_rs = (a_rs + 2**31) % 2**32 - 2**31
            # the epilogue: pixels inside the output, columns below Oc
            oy, ox = oy0 + ty, ox0 + m - ty * tw
            keep = (oy < oh) & (ox < ow)
            for j in range(bn):
                if n0 + j < oc:
                    acc[img, oy[keep], ox[keep], n0 + j] = a_sum[keep, j]
                    np.add.at(written, (img, oy[keep], ox[keep], n0 + j), 1)
            rs[img, oy[keep], ox[keep]] = a_rs[keep]
    assert written.min() == 1 and written.max() == 1
    return acc, rs


def _mma_plans(geom):
    """conv_plan's mma plan, then each N tile on the other pixel tile and,
    for Ci of several slabs, one slab a group; last, the plan's own tile
    as a gathering block."""
    n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
    oh, ow = out_size(geom)
    plan = _plan(geom)
    assert plan.branch == "mma", plan
    yield plan
    for v in range(len(QC.MMA_NTILES)):
        for pixels in QC.MMA_PIXELS:
            if (v, QC.mma_tile(pixels)) == (plan.variant, plan.tile):
                continue
            th, tw = QC.mma_tile(pixels)
            slabs = 1 if v == 1 else plan.slabs
            yield QC.mma_plan(v, n, oh, ow, oc, kh, kw, stride, dil, th,
                              tw, slabs)
    yield QC.mma_plan(plan.variant, n, oh, ow, oc, kh, kw, stride, dil,
                      *plan.tile, plan.slabs, gather=True)


@pytest.mark.parametrize("oc", [1, 4, 12, 65])
@pytest.mark.parametrize("ci", [3, 12, 56, 72])
def test_mma_replay_matches_pallas(ci, oc):
    """Stride 1 on a zero-point-padded input, the Pallas kernel's own
    form: the replay of the unpadded input with its padding read as x_zp,
    under conv_plan's plan and forced N tiles, pixel tiles and channel
    groups, is byte-equal to band_tpu's Pallas kernel (interpret mode) and
    to the plain version, for w_zp 0 and 3 and int8 and uint8 out (a
    rounding each)."""
    rng = np.random.default_rng(80 + ci + oc)
    n, h, w, kh, kw, x_zp = 1, 9, 21, 3, 3, -9
    pads = ((1, 1), (1, 1))
    x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    x_pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=x_zp)
    wk = rng.integers(-128, 128, (kh * kw * ci, oc)).astype(np.int8)
    m = 30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0) * rng.uniform(0.5, 2, oc)
    qm, sh = JQ.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, oc).astype(np.int32)
    geom = (n, h, w, ci, oc, kh, kw, (1, 1), (1, 1), pads)
    t = torch.from_numpy
    combos = [(0, np.int8), (3, np.uint8), (3, np.int8), (0, np.uint8)]
    for i, plan in enumerate(_mma_plans(geom)):
        acc, rs = _replay_mma(x, wk, plan, kh, kw, (1, 1), (1, 1), pads,
                              x_zp)
        for j, (w_zp, out_dtype) in enumerate(combos):
            rounding = ROUNDINGS[(i + j) % 3]
            rq = _requant_args(out_dtype)
            od = Q.torch_dtype(out_dtype)
            got = Q.requantize_exact(_accumulate(acc, rs, bias, w_zp),
                                     t(qm).long(), t(sh).long(),
                                     rq["out_zp"], rq["qmin"], rq["qmax"],
                                     od, rounding).numpy()
            plain = QC.qconv2d_plain(
                t(x), t(wk), t(bias), t(qm), t(sh), kh=kh, kw=kw,
                padding=pads, x_zp=x_zp, w_zp=w_zp, rounding=rounding,
                out_dtype=od, **rq).numpy()
            np.testing.assert_array_equal(got, plain, err_msg=plan.name)
            if i == 0:
                want = np.asarray(pallas_qconv(
                    jnp.asarray(x_pad), jnp.asarray(wk), jnp.asarray(bias),
                    jnp.asarray(qm), jnp.asarray(sh), kh=kh, kw=kw,
                    rounding=rounding, w_zp=w_zp, out_dtype=out_dtype,
                    tile_h=h, interpret=True, **rq))
                np.testing.assert_array_equal(got, want, err_msg=plan.name)


@pytest.mark.parametrize("geom,offset", [
    # (n, h, w, ci, oc, kh, kw, stride, dilation, padding), x's offset
    ((2, 13, 11, 12, 12, 3, 3, (2, 2), (1, 1), ((0, 1), (1, 0))), 0),
    ((1, 12, 19, 56, 4, 3, 3, (1, 1), (2, 2), ((2, 3), (1, 2))), 0),
    ((1, 11, 17, 72, 65, 5, 4, (2, 1), (1, 2), ((2, 1), (3, 0))), 0),
    ((2, 9, 10, 3, 1, 3, 3, (1, 2), (2, 1), ((0, 2), (1, 1))), 1),
    ((1, 7, 33, 40, 12, 1, 3, (1, 1), (1, 1), ((0, 0), (2, 0))), 8),
    ((1, 6, 18, 200, 32, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), 0),
])
@pytest.mark.parametrize("w_zp,out_dtype", [(0, np.int8), (3, np.uint8)])
def test_mma_replay_matches_plain(geom, offset, w_zp, out_dtype):
    """Stride 2, dilation 2, asymmetric padding, a ragged Ci whose copies
    are bytes (x one byte off alignment) or 8 bytes, and Ci 200 in
    several channel groups: the replay under each plan of _mma_plans is
    byte-equal to the plain version."""
    n, h, w, ci, oc, kh, kw, stride, dil, pads = geom
    rng = np.random.default_rng(90 + ci + oc)
    x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    wk = rng.integers(-128, 128, (kh * kw * ci, oc)).astype(np.int8)
    m = 30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0) * rng.uniform(0.5, 2, oc)
    qm, sh = JQ.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, oc).astype(np.int32)
    rq = _requant_args(out_dtype)
    od = Q.torch_dtype(out_dtype)
    t = torch.from_numpy
    plain = QC.qconv2d_plain(t(x), t(wk), t(bias), t(qm), t(sh), kh=kh,
                             kw=kw, stride=stride, dilation=dil, padding=pads,
                             x_zp=-9, w_zp=w_zp, rounding="double",
                             out_dtype=od, **rq).numpy()
    plans = list(_mma_plans(geom))
    if ci == 200:
        assert plans[0].slabs < 13  # several channel groups
    for plan in plans:
        acc, rs = _replay_mma(x, wk, plan, kh, kw, stride, dil, pads, -9,
                              offset)
        got = Q.requantize_exact(_accumulate(acc, rs, bias, w_zp),
                                 t(qm).long(), t(sh).long(), rq["out_zp"],
                                 rq["qmin"], rq["qmax"], od,
                                 "double").numpy()
        np.testing.assert_array_equal(got, plain, err_msg=plan.name)


@pytest.mark.parametrize("data", ["extreme", "random"])
@pytest.mark.parametrize("w_zp,out_dtype", [(0, np.int8), (3, np.uint8)])
def test_mma_replay_k_beyond_2_17_matches_plain(data, w_zp, out_dtype):
    """K of 147,456 bytes (3x3 taps, Ci 16384): the plan's channel groups
    each stay below MAX_MMA_K bytes, so each group's sums are exact in
    int32 (asserted in the replay), and the groups add modulo 2^32.  With
    every x, x_zp and weight at -128 the sum is 9 * 16384 * 2^14 =
    2,415,919,104, past int32: the replay still equals the plain
    version's int32 wrap, and so does random data."""
    n, h, w, ci, oc, kh, kw = 1, 2, 3, 16384, 4, 3, 3
    pads = ((1, 1), (1, 1))
    rng = np.random.default_rng(17)
    if data == "extreme":
        x = np.full((n, h, w, ci), -128, np.int8)
        wk = np.full((kh * kw * ci, oc), -128, np.int8)
    else:
        x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
        wk = rng.integers(-128, 128, (kh * kw * ci, oc)).astype(np.int8)
    plan = _plan((n, h, w, ci, oc, kh, kw, (1, 1), (1, 1), pads))
    assert plan.branch == "mma" and -(-1024 // plan.slabs) > 1, plan
    acc, rs = _replay_mma(x, wk, plan, kh, kw, (1, 1), (1, 1), pads, -128)
    if data == "extreme":
        assert (acc == 2415919104 - 2**32).all()
    m = 30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0) * rng.uniform(0.5, 2, oc)
    qm, sh = JQ.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, oc).astype(np.int32)
    rq = _requant_args(out_dtype)
    od = Q.torch_dtype(out_dtype)
    t = torch.from_numpy
    got = Q.requantize_exact(_accumulate(acc, rs, bias, w_zp), t(qm).long(),
                             t(sh).long(), rq["out_zp"], rq["qmin"],
                             rq["qmax"], od, "ruy").numpy()
    plain = QC.qconv2d_plain(t(x), t(wk), t(bias), t(qm), t(sh), kh=kh,
                             kw=kw, padding=pads, x_zp=-128, w_zp=w_zp,
                             rounding="ruy", out_dtype=od, **rq).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("ci", [3, 12, 56])
def test_mma_k_enumeration(ci):
    """K in 16-byte chunks, tap-major: chunk c of a group is tap c // gs,
    slab c % gs; its patch offset is the tap's (dy * dh, dx * dw) pixel
    times the pixel stride plus 16 per slab; an odd count gets one pad
    chunk, whose weights are zero and which the window sum skips; every
    weight byte past Ci is zero, and so is every patch byte past Ci,
    inside the image or out."""
    kh, kw, dh, dw = 3, 5, 2, 1
    nslab = -(-ci // 16)
    plan = QC.mma_plan(0, 1, 4, 16, 4, kh, kw, (1, 1), (dh, dw), 8, 16,
                       nslab)
    ph, pw = plan.patch
    ps, ws, ksteps, _ = QC.mma_layout(ph, pw, kh, kw, nslab)
    nchunks = kh * kw * nslab
    assert ksteps == -(-nchunks // 2)
    assert (2 * ksteps - nchunks) == nchunks % 2
    for c in range(nchunks):
        tap, slab = divmod(c, nslab)
        dy, dx = divmod(tap, kw)
        t = _fastdiv(c, nslab)
        dyf = _fastdiv(t, kw)
        assert (t, dyf) == (tap, dy)
        off = (dyf * dh * pw + (t - dyf * kw) * dw) * ps + 16 * (c - t * nslab)
        assert off == (dy * dh * pw + dx * dw) * ps + 16 * slab
    rng = np.random.default_rng(ci)
    x = rng.integers(-128, 128, (1, 4, 16, ci)).astype(np.int8)
    wk = rng.integers(-128, 128, (kh * kw * ci, 4)).astype(np.int8)
    pads = ((2, 2), (2, 2))
    acc, rs = _replay_mma(x, wk, plan, kh, kw, (1, 1), (dh, dw), pads, 77)
    xp = np.pad(x.astype(np.int64), ((0, 0), (2, 2), (2, 2), (0, 0)),
                constant_values=77)
    want = np.zeros_like(rs)
    for dy in range(kh):
        for dx in range(kw):
            want += xp[:, dy * dh:dy * dh + 4, dx * dw:dx * dw + 16].sum(-1)
    # x_zp at positions outside the image, each once per tap; no pad byte
    # and no pad chunk counted
    np.testing.assert_array_equal(rs, want)


@pytest.mark.parametrize("ci", [3, 56])
def test_mma_pad_byte_must_be_zero_for_the_window_sum(ci):
    """The window sum that w_zp multiplies is an MMA of the patch's 16-byte
    chunks against ones: with x_zp in the pad bytes past Ci (instead of 0)
    every output would count x_zp once per pad byte and tap, and the sums
    would differ from the plain version's."""
    rng = np.random.default_rng(70 + ci)
    x = rng.integers(-128, 128, (1, 5, 6, ci)).astype(np.int8)
    wk = rng.integers(-128, 128, (9 * ci, 8)).astype(np.int8)
    pads = ((1, 1), (1, 1))
    plan = _plan((1, 5, 6, ci, 9, 3, 3, (1, 1), (1, 1), pads))
    plan = QC.mma_plan(0, 1, 5, 6, 8, 3, 3, (1, 1), (1, 1), *plan.tile,
                       plan.slabs)
    _, rs = _replay_mma(x, wk, plan, 3, 3, (1, 1), (1, 1), pads, -9)
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                constant_values=-9)
    want = np.zeros_like(rs)
    for dy in range(3):
        for dx in range(3):
            want += xp[:, dy:dy + 5, dx:dx + 6].sum(-1)
    np.testing.assert_array_equal(rs, want)
    pad_bytes = 16 * -(-ci // 16) - ci
    assert pad_bytes > 0  # with x_zp there, rs would move by -9 per byte
