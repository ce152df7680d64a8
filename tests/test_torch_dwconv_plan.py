"""The int8 depthwise conv's launch plan (``dwconv_plan``: variant, block
and grid per shape) and the strip kernel's tap gather, on the CPU.

The CUDA kernel (csrc/qdwconv.cu) runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it byte-equal to the
plain version.  Here numpy replays what it does: the plan's grid is
walked thread by thread to show that it writes every output exactly
once, and each thread's work (its input window loaded once as 32-bit
words, each column's rows gathered per channel with the kernel's
__byte_perm selectors, its weights masked past kh, one dp4a per gathered
column, each column serving every output of the strip that covers it) is
replayed and held byte-equal (tolerance 0) to band_tpu's Pallas kernel
in interpret mode and to the plain version."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from band_tpu.ops import quant as JQ
from band_tpu.ops.pallas.qdwconv import qdwconv2d_exact as pallas_qdwconv
from band_tpu_torch.ops import quant as Q
from band_tpu_torch.ops.kernels import qdwconv as QD
from band_tpu_torch.ops.kernels.sweep_dwconv import dwconv_shapes, out_size


def _plan(geom, align=16):
    n, h, w, c, mult, kh, kw, stride, dil, _ = geom
    oh, ow = out_size(geom)
    return QD.dwconv_plan(n, oh, ow, c, mult, kh, kw, stride, dil, align)


def _outputs_written(plan, n, oh, ow, co):
    """How often the plan's grid writes each output (n, oy, ox, c): every
    thread of every block, as the kernel indexes them."""
    count = np.zeros(n * oh * ow * co, np.int64)
    gx, gy, gz = plan.grid
    bx, by = plan.block
    if plan.variant < 0:
        idx = np.arange(gx * bx)
        np.add.at(count, idx[idx < count.size], 1)
        return count.reshape(n, oh, ow, co)
    vec, r = plan.vec, plan.r
    groups, strips = co // vec, -(-ow // r)
    g = np.arange(gx * bx)                      # blockIdx.x * bx + tid.x
    s = np.arange(gy * by)                      # blockIdx.y * by + tid.y
    z = np.arange(gz)                           # blockIdx.z
    g, s, z = (a.ravel() for a in np.meshgrid(g, s, z, indexing="ij"))
    live = (g < groups) & (s < strips)
    g, s, z = g[live], s[live], z[live]
    nn, oy = z // oh, z % oh
    for j in range(r):
        ox = s * r + j
        keep = ox < ow
        for b in range(vec):
            c = g * vec + b
            flat = ((nn * oh + oy) * ow + ox) * co + c
            np.add.at(count, flat[keep], 1)
    return count.reshape(n, oh, ow, co)


def _check_cover(geom, align=16):
    n, h, w, c, mult, *_ = geom
    oh, ow = out_size(geom)
    plan = _plan(geom, align)
    assert plan.threads <= QD.MAX_THREADS and plan.grid[2] <= QD.MAX_GRID_Z
    written = _outputs_written(plan, n, oh, ow, c * mult)
    assert written.min() == 1 and written.max() == 1, (geom, plan)
    return plan


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


@pytest.mark.parametrize("model,batch", [
    ("mobilenet_v2_int8", 1), ("mobilenet_v2_int8", 8),
    ("effnetlite_int8", 1), ("effnetlite_int8", 8)])
def test_plan_covers_every_depthwise_call(model, batch, one_thread):
    # captured from the port's program run on the CPU
    shapes = dwconv_shapes(batch, model)
    assert sum(shapes.values()) == (17 if model.startswith("mobilenet")
                                    else 4)
    for geom in shapes:
        plan = _check_cover(geom)
        # every call of these models takes the strip kernel, 4 channels
        # to a thread, in blocks that fill half the card's SMs or that
        # cannot shrink further
        assert plan.variant >= 0 and plan.vec == QD.VEC, (geom, plan)
        assert plan.blocks >= QD.MIN_BLOCKS or plan.threads <= 32, plan


RAGGED = [
    # (n, h, w, c, mult, kh, kw, stride, dilation, padding), align
    ((2, 9, 11, 7, 1, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), 16),
    ((1, 12, 13, 13, 1, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))), 16),
    ((2, 7, 10, 33, 1, 5, 5, (1, 1), (1, 1), ((2, 2), (2, 2))), 16),
    ((2, 8, 9, 5, 3, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), 16),
    ((1, 14, 13, 24, 1, 3, 3, (2, 1), (1, 1), ((1, 1), (1, 1))), 16),
    ((1, 11, 11, 16, 1, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))), 16),
    ((3, 9, 23, 40, 1, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))), 1),
    ((2, 15, 17, 48, 1, 5, 5, (2, 2), (1, 1), ((1, 2), (1, 2))), 2),
    ((1, 6, 6, 8, 1, 3, 5, (1, 1), (1, 1), ((1, 1), (2, 2))), 16),
]


@pytest.mark.parametrize("geom,align", RAGGED)
def test_plan_covers_ragged_shapes(geom, align):
    plan = _check_cover(geom, align)
    n, h, w, c, mult, kh, kw, stride, dil, _ = geom
    # a ragged C or a misaligned base takes the general loop
    strip = (c % QD.VEC == 0 and align % QD.VEC == 0 and mult == 1
             and dil == (1, 1) and kh == kw and stride[1] in (1, 2))
    assert (plan.variant >= 0) == strip, plan
    assert plan.vec == (QD.VEC if strip else 1)
    if strip:
        assert QD.VARIANTS[plan.variant][:2] == (kh, stride[1])


@pytest.mark.parametrize("threads,block_strips",
                         [(32, 1), (QD.MAX_THREADS, QD.BLOCK_STRIPS)])
@pytest.mark.parametrize("ow", [1, 2, 3, 4, 5, 7, 9])
@pytest.mark.parametrize("variant", range(len(QD.VARIANTS)))
def test_every_variant_covers_any_width(variant, ow, threads, block_strips):
    """Each strip variant, forced, under the smallest and the largest
    block: OW not a multiple of the strip, C a multiple of the vector."""
    c = 3 * QD.VEC
    plan = QD.strip_plan(variant, 2, 3, ow, c, threads, block_strips)
    written = _outputs_written(plan, 2, 3, ow, c)
    assert written.min() == 1 and written.max() == 1, plan


SRC = os.path.join(os.path.dirname(QD.__file__), "csrc", "qdwconv.cu")


def test_variants_match_the_kernel_source():
    src = open(SRC).read()
    cases = re.findall(r"case (\d+): return launch_strip<(\d+), (\d+), "
                       r"(\d+), WZP>", src)
    assert [int(c[0]) for c in cases] == list(range(len(QD.VARIANTS)))
    assert [tuple(int(v) for v in c[1:]) for c in cases] == list(
        QD.VARIANTS)
    assert re.search(r"constexpr int kMaxThreads = (\d+);",
                     src).group(1) == str(QD.MAX_THREADS)
    assert re.search(r"constexpr int kVec = (\d+);",
                     src).group(1) == str(QD.VEC)
    assert all(kh in (3, 5) and sw in (1, 2) for kh, sw, _ in QD.VARIANTS)


def test_gather_matches_the_kernel_source():
    """The replay below uses the kernel's gather() and low_bytes() as
    written in the source, selector for selector."""
    src = " ".join(open(SRC).read().split())
    for line in GATHER_SOURCE:
        assert " ".join(line.split()) in src, line


# --------------------------------------------------------------------------
# one thread's tap gather, replayed
# --------------------------------------------------------------------------

# gather() and low_bytes() of csrc/qdwconv.cu, which _byte_perm,
# _gather and _low_bytes below replay
GATHER_SOURCE = [
    "const uint32_t lo = __byte_perm(r0, r1, b | ((b + 4) << 4));",
    "if (m <= 2) return lo;",
    "if (m == 3) return __byte_perm(lo, r2, 0x0010 | ((b + 4) << 8));",
    "return __byte_perm(lo, __byte_perm(r2, r3, b | ((b + 4) << 4)), 0x5410);",
    "return m >= 4 ? 0xffffffffu : (1u << (8 * m)) - 1u;",
    "wp[dx][k] = gather(row(0), row(1), row(2), row(3), m, b) & low_bytes(m);",
    "xp[j][k] = gather(row(0), row(1), row(2), row(3), m, b);",
    "a = __dp4a(xv, static_cast<int>(wp[dx][k]), a);",
    "sum = __dp4a(xv, static_cast<int>(0x01010101u & low_bytes(m)), sum);",
]


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


def _gather(r0, r1, r2, r3, m, b):
    lo = _byte_perm(r0, r1, b | ((b + 4) << 4))
    if m <= 2:
        return lo
    if m == 3:
        return _byte_perm(lo, r2, 0x0010 | ((b + 4) << 8))
    return _byte_perm(lo, _byte_perm(r2, r3, b | ((b + 4) << 4)), 0x5410)


def _low_bytes(m):
    return 0xffffffff if m >= 4 else (1 << (8 * m)) - 1


def _dp4a(a, b, c):
    """__dp4a: the four signed byte products of a and b, added to c."""
    for i in range(4):
        sa = ((a >> np.uint32(8 * i)) & np.uint32(0xff)).astype(np.int64)
        sb = ((np.asarray(b, np.uint32) >> np.uint32(8 * i))
              & np.uint32(0xff)).astype(np.int64)
        c = c + ((sa ^ 0x80) - 0x80) * ((sb ^ 0x80) - 0x80)
    return c


def _words(b):
    """int8 [..., 4] -> uint32 [...], byte 0 lowest (a 32-bit load)."""
    u = b.astype(np.uint8).astype(np.uint32)
    return u[..., 0] | u[..., 1] << 8 | u[..., 2] << 16 | u[..., 3] << 24


def _replay_acc(x, w, plan, kh, kw, stride, dilation, padding, x_zp):
    """The raw sums (the kernel's acc) and window sums (its rs) of every
    output, computed as the plan's threads compute them."""
    n, h, wd, ci = x.shape
    co = w.shape[1]
    mult = co // ci
    (pt, _), (pl, _) = padding
    sh, sw = stride
    dh, dw = dilation
    oh = (h + sum(padding[0]) - (kh - 1) * dh - 1) // sh + 1
    ow = (wd + sum(padding[1]) - (kw - 1) * dw - 1) // sw + 1
    acc = np.zeros((n, oh, ow, co), np.int64)
    rs = np.zeros_like(acc)

    if plan.variant < 0:
        # one thread per output byte: the index split by division
        def px(nn, iy, ix, c):  # a tap's input byte, x_zp in the padding
            inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            v = x[nn, np.clip(iy, 0, h - 1), np.clip(ix, 0, wd - 1), c]
            return np.where(inside, v.astype(np.int64), x_zp)

        idx = np.arange(n * oh * ow * co)
        c, rest = idx % co, idx // co
        ox, rest = rest % ow, rest // ow
        oy, nn = rest % oh, rest // oh
        for dy in range(kh):
            for dx in range(kw):
                v = px(nn, oy * sh - pt + dy * dh, ox * sw - pl + dx * dw,
                       c // mult)
                acc.reshape(-1)[idx] += v * w[dy * kw + dx, c]
                rs.reshape(-1)[idx] += v
        return acc, rs
    assert (kh, sw) == QD.VARIANTS[plan.variant][:2] and mult == 1
    r, vec = plan.r, QD.VEC
    cols = (r - 1) * sw + kw
    ng = (kh + 3) // 4
    # every live thread at once: g (channel group), s (strip), z (n * oh)
    gx, gy, gz = plan.grid
    bx, by = plan.block
    g, s, z = (a.ravel() for a in np.meshgrid(
        np.arange(gx * bx), np.arange(gy * by), np.arange(gz),
        indexing="ij"))
    live = (g < ci // vec) & (s < -(-ow // r))
    g, s, z = g[live], s[live], z[live]
    nn, oy = z // oh, z % oh
    c0, ox0 = g * vec, s * r
    chans = c0[:, None] + np.arange(vec)
    # every load first: tap weights and the window, one word per pixel
    wr = [_words(w[t][chans]) for t in range(kh * kw)]
    zp4 = np.uint32(0x01010101 * (x_zp & 0xff))
    xr = [[None] * cols for _ in range(kh)]
    for dy in range(kh):
        iy = oy * sh - pt + dy
        for j in range(cols):
            ix = ox0 * sw - pl + j
            inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            word = _words(x[nn[:, None], np.clip(iy, 0, h - 1)[:, None],
                            np.clip(ix, 0, wd - 1)[:, None], chans])
            xr[dy][j] = np.where(inside, word, zp4)

    def rows(words, k):  # row(i) of the kernel: 0 past kh
        return [words[4 * k + i] if 4 * k + i < kh else np.uint32(0)
                for i in range(4)]

    for b in range(vec):
        wp = [[_gather(*rows([wr[dy * kw + dx] for dy in range(kh)], k),
                       min(kh - 4 * k, 4), b)
               & np.uint32(_low_bytes(min(kh - 4 * k, 4)))
               for k in range(ng)] for dx in range(kw)]
        xp = [[_gather(*rows([xr[dy][j] for dy in range(kh)], k),
                       min(kh - 4 * k, 4), b)
               for k in range(ng)] for j in range(cols)]
        for j in range(r):
            a = np.zeros(len(g), np.int64)
            t = np.zeros(len(g), np.int64)
            for dx in range(kw):
                for k in range(ng):
                    m = min(kh - 4 * k, 4)
                    xv = xp[j * sw + dx][k]  # column reused across the strip
                    a = _dp4a(xv, wp[dx][k], a)
                    t = _dp4a(xv, 0x01010101 & _low_bytes(m), t)
            ox = ox0 + j
            keep = ox < ow
            acc[nn[keep], oy[keep], ox[keep], c0[keep] + b] = a[keep]
            rs[nn[keep], oy[keep], ox[keep], c0[keep] + b] = t[keep]
    return acc, rs


def _requant(acc, rs, bias, w_zp):
    return Q.wrap32(torch.from_numpy(acc - w_zp * rs + bias.astype(np.int64)))


GATHER = [
    # (n, h, w, c, mult, kh, stride, dilation, padding, align, w_zp, out,
    #  the rounding band_tpu's Pallas kernel is run with)
    (2, 7, 9, 16, 1, 3, (1, 1), (1, 1), ((0, 0), (0, 0)), 16, 0, np.int8,
     "ruy"),
    (1, 9, 11, 8, 1, 3, (2, 2), (1, 1), ((0, 0), (0, 0)), 16, 3, np.uint8,
     "double"),
    (1, 8, 10, 12, 1, 5, (1, 1), (1, 1), ((0, 0), (0, 0)), 16, 0, np.int8,
     "single"),
    (1, 9, 8, 8, 1, 3, (2, 1), (1, 1), ((0, 0), (0, 0)), 16, 0, np.int8,
     "ruy"),
    (2, 6, 7, 7, 1, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 16, 0, np.int8,
     None),
    (1, 9, 9, 8, 1, 3, (2, 2), (1, 1), ((0, 1), (0, 1)), 16, -4, np.uint8,
     None),
    (2, 7, 9, 12, 1, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 1, 0, np.int8,
     None),
    (1, 8, 9, 12, 1, 5, (2, 2), (1, 1), ((2, 2), (2, 2)), 16, 0, np.int8,
     None),
    (1, 9, 9, 8, 1, 3, (1, 1), (2, 2), ((2, 2), (2, 2)), 16, 0, np.int8,
     None),
    (2, 6, 7, 5, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 16, 2, np.int8,
     None),
]


@pytest.mark.parametrize(
    "n,h,w,c,mult,kh,stride,dilation,padding,align,w_zp,out_dtype,pallas",
    GATHER)
def test_thread_replay_matches_pallas_and_plain(
        n, h, w, c, mult, kh, stride, dilation, padding, align, w_zp,
        out_dtype, pallas):
    """Strip and general plans replayed thread by thread: padding read as
    x_zp, strides, dilation, multiplier, w_zp, a ragged C and a
    misaligned base (the general loop).  A strip geometry is replayed
    under its plan and under every strip width of its variant table, all
    equal.  Cases without padding, dilation or multiplier also go through
    band_tpu's Pallas kernel (which takes x pre-padded)."""
    rng = np.random.default_rng(40 + h * c + kh)
    co = c * mult
    x_zp = -9
    x = rng.integers(-128, 128, (n, h, w, c)).astype(np.int8)
    wk = rng.integers(-128, 128, (kh * kh, co)).astype(np.int8)
    m = 30.0 / (3.0 * 73.0 * 73.0) * rng.uniform(0.5, 2.0, co)
    qm, sh = JQ.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, co).astype(np.int32)
    out = (dict(out_zp=128, qmin=0, qmax=255) if out_dtype == np.uint8
           else dict(out_zp=-3, qmin=-128, qmax=127))
    geom = (n, h, w, c, mult, kh, kh, stride, dilation, padding)
    plan = _plan(geom, align)
    assert (plan.variant >= 0) == (mult == 1 and dilation == (1, 1)
                                   and c % 4 == 0 and align % 4 == 0)
    acc, rs = _replay_acc(x, wk, plan, kh, kh, stride, dilation, padding,
                          x_zp)
    if plan.variant >= 0:
        oh, ow = out_size(geom)
        for v, (k, s, _) in enumerate(QD.VARIANTS):
            if (k, s) == (kh, stride[1]):
                forced = QD.strip_plan(v, n, oh, ow, c, 32, 2)
                again = _replay_acc(x, wk, forced, kh, kh, stride, dilation,
                                    padding, x_zp)
                assert np.array_equal(again[0], acc), forced
                assert np.array_equal(again[1], rs), forced
    a = _requant(acc, rs, bias, w_zp)
    t = torch.from_numpy
    od = Q.torch_dtype(out_dtype)
    conv = dict(kh=kh, kw=kh, stride=stride, dilation=dilation,
                padding=padding, x_zp=x_zp, w_zp=w_zp, out_dtype=od, **out)
    for rounding in ("single", "double", "ruy"):
        got = Q.requantize_exact(a, t(qm).long(), t(sh).long(),
                                 out["out_zp"], out["qmin"], out["qmax"], od,
                                 rounding).numpy()
        plain = QD.qdwconv2d_plain(t(x), t(wk), t(bias), t(qm), t(sh),
                                   rounding=rounding, **conv).numpy()
        np.testing.assert_array_equal(got, plain)
        if rounding == pallas:
            assert padding == ((0, 0), (0, 0)) and plan.variant >= 0
            want = np.asarray(pallas_qdwconv(
                jnp.asarray(x), jnp.asarray(wk.astype(np.int32)),
                jnp.asarray(bias), jnp.asarray(qm), jnp.asarray(sh), kh=kh,
                kw=kh, sh=stride[0], sw=stride[1], rounding=rounding,
                w_zp=w_zp, out_dtype=out_dtype, tile_h=out_size(geom)[0],
                **out))
            np.testing.assert_array_equal(got, want)
        # the outputs are not all clamped to one end
        assert len(np.unique(got)) > 8
    # the fast instance: the same sums through the float32 requant
    mult_f = t(m.astype(np.float32))
    fast = Q.requantize_fast(a, mult_f, out["out_zp"], out["qmin"],
                             out["qmax"], od).numpy()
    np.testing.assert_array_equal(fast, QD.qdwconv2d_fast_plain(
        t(x), t(wk), t(bias), mult_f, **conv).numpy())
