"""The int8 conv's launch plan (``conv_plan``: the direct kernel and its
tile, or the general implicit-GEMM loop) and the direct kernel's block
and thread arithmetic, on the CPU.

The CUDA kernel (csrc/qconv.cu) runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it byte-equal to the
plain version.  Here numpy replays what it does, block by block and
thread by thread: the weights staged as dp4a words (zero bytes past
Ci), the input patch staged with x_zp outside the image and zero pad
bytes, each thread's P pixels x CV channels of __dp4a over the tap
words, the window sum as a dp4a with 0x01010101, and the tile edges.
The replay is held byte-equal (tolerance 0) to band_tpu's Pallas kernel
in interpret mode (stride 1 on a zero-point-padded input) and to
band_tpu's lowering of CONV_2D (conv_mode="f32_split") at stride 2."""

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


@pytest.mark.parametrize("geom,direct", [
    # (n, h, w, ci, oc, kh, kw, stride, dilation, padding)
    ((2, 17, 15, 8, 24, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), True),
    ((1, 19, 19, 16, 70, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))), False),
    ((2, 12, 12, 5, 9, 5, 5, (1, 2), (1, 1), ((2, 2), (1, 2))), False),
    ((1, 9, 9, 4, 128, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), False),
    ((1, 9, 9, 512, 64, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), False),
    ((1, 30, 30, 64, 64, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))), False),
    ((1, 30, 30, 16, 64, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))), True),
    ((2, 9, 9, 12, 16, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), True),
    ((3, 7, 9, 1, 8, 5, 3, (2, 1), (1, 2), ((2, 2), (2, 2))), True),
    ((1, 1, 300, 3, 16, 1, 3, (1, 1), (1, 1), ((0, 0), (1, 1))), True),
])
def test_plan_branches(geom, direct):
    """Ci above 16, Oc not a multiple of 8 or above 64, weights off an
    8-byte boundary, or a patch and weights beyond 48 KB of shared
    memory, take the general loop; the rest the direct kernel, whose grid
    writes each output exactly once."""
    n, h, w, ci, oc, *_ = geom
    plan = _plan(geom)
    assert (plan.variant >= 0) == direct, plan
    for align in (1, 2, 4):
        assert _plan(geom, align) == QC.general_plan(n, *out_size(geom), oc)
    if direct:
        assert QC.fits(plan, ci, oc)
        count = _written(plan, n, *out_size(geom), oc)
        assert count.min() == 1 and count.max() == 1, plan
    else:
        assert plan == QC.general_plan(n, *out_size(geom), oc)


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
    src = " ".join(open(SRC).read().split())
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
    """qgemm.cuh takes its row tiles from blockIdx.x (up to 2^31 - 1
    blocks) and its column tiles from y (65,535 at most): a b32 window
    of FSRCNN's 360x640 outputs has 115,200 row tiles."""
    src = open(SRC).read()
    gemm = open(os.path.join(os.path.dirname(SRC), "qgemm.cuh")).read()
    assert "const dim3 grid((M + kBM - 1) / kBM, (oc + kBN - 1) / kBN);" \
        in src
    assert "const int m0 = blockIdx.x * kBM;" in gemm
    assert "const int n0 = blockIdx.y * kBN;" in gemm
    p = QC.conv_plan(32, 360, 640, 12, 12, 3, 3, (1, 1), (1, 1), 16)
    assert p == QC.general_plan(32, 360, 640, 12)
    assert p.grid == (115200, 1, 1)
