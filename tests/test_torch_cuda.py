"""The port on the card: each CUDA kernel byte-equal to its plain
PyTorch version (tolerance 0), and a GPU worker serving the goldens.
Every test here is marked ``cuda`` and skips without CUDA (a CUDA kernel
has no CPU mode; the plain versions are held to band_tpu by the other
test_torch_* files).

This file imports neither jax nor band_tpu, so it also runs on a machine
without them; there, skip the repository's conftest (which sets up jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools
import os

import numpy as np
import pytest
import torch

import band_tpu_torch as bt
from band_tpu_torch.ops import kernels as K
from band_tpu_torch.ops import quant as Q
from band_tpu_torch.ops.kernels import qconv as QC
from band_tpu_torch.ops.kernels import qdwconv as QD
from band_tpu_torch.ops.kernels import softmax as SM

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROUNDINGS = ["single", "double", "ruy"]
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _epilogue(rng, n, k, dev):
    m = 30.0 / (np.sqrt(k) * 73.0 * 73.0) * rng.uniform(0.5, 2.0, n)
    qm, sh = Q.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, n).astype(np.int32)
    return [torch.from_numpy(v).to(dev) for v in (bias, qm, sh)]


def _i8(rng, dev, *shape):
    return torch.from_numpy(
        rng.integers(-128, 128, shape).astype(np.int8)).to(dev)


# GEMM shapes that reach every branch of gemm_plan (each tile width, tall
# and short tiles, K split or not) and every copy width (row strides of
# 16, 8 and 1 bytes); a third of them take A one byte into a buffer, so
# that the kernel copies A byte by byte
GEMM_SHAPES = list(itertools.product((0, 1, 7, 49, 392, 12545),
                                     (16, 24, 27, 960, 1280),
                                     (16, 24, 1000)))


def _gemm_operands(rng, dev, i, m, k, n):
    if i % 3 == 1:
        a = _i8(rng, dev, m * k + 1)[1:].view(m, k)
        assert m == 0 or a.data_ptr() % 2 == 1
    else:
        a = _i8(rng, dev, m, k)
    return a, _i8(rng, dev, k, n)


def _args(out_dtype, rounding, w_zp):
    if out_dtype == torch.uint8:
        return dict(out_zp=128, qmin=0, qmax=255, rounding=rounding,
                    w_zp=w_zp, out_dtype=out_dtype)
    return dict(out_zp=-3, qmin=-128, qmax=127, rounding=rounding,
                w_zp=w_zp, out_dtype=out_dtype)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("w_zp,out_dtype", [(0, torch.int8),
                                            (5, torch.uint8)])
def test_kernels_match_plain(dev, rounding, w_zp, out_dtype):
    rng = np.random.default_rng(17)
    args = _args(out_dtype, rounding, w_zp)
    a, b = _i8(rng, dev, 70, 27), _i8(rng, dev, 27, 20)
    epi = _epilogue(rng, 20, 27, dev)
    K.reset_launches()
    got = K.qmatmul_exact(a, b, *epi, **args)
    assert K.launch_counts()["qmatmul_exact"] == 1
    assert torch.equal(got, K.qmatmul_plain(a, b, *epi, **args))
    x = _i8(rng, dev, 2, 9, 10, 4)
    wk = _i8(rng, dev, 9 * 4, 20)
    conv = dict(args, kh=3, kw=3, stride=(2, 1), dilation=(1, 2),
                padding=((1, 1), (2, 2)), x_zp=-6)
    assert torch.equal(K.qconv2d_exact(x, wk, *epi, **conv),
                       K.qconv2d_plain(x, wk, *epi, **conv))
    wd = _i8(rng, dev, 9, 8)
    epi8 = _epilogue(rng, 8, 9, dev)
    dw = dict(args, kh=3, kw=3, stride=(2, 2), padding=((0, 1), (0, 1)),
              x_zp=4, dilation=(1, 1))
    assert torch.equal(K.qdwconv2d_exact(x, wd, *epi8, **dw),
                       K.qdwconv2d_plain(x, wd, *epi8, **dw))
    assert K.launch_counts()["qconv2d_exact"] == 1
    assert K.launch_counts()["qdwconv2d_exact"] == 1
    # every plan branch; qm/shift per channel and per tensor in turn
    for i, (m, k, n) in enumerate(GEMM_SHAPES):
        a, b = _gemm_operands(rng, dev, i, m, k, n)
        bias, qm, sh = _epilogue(rng, n, k, dev)
        if i % 2:
            qm, sh = qm[:1], sh[:1]
        got = K.qmatmul_exact(a, b, bias, qm, sh, **args)
        want = K.qmatmul_plain(a, b, bias, qm, sh, **args)
        assert torch.equal(got, want), (m, k, n, K.gemm_plan(m, n, k))
    assert K.launch_counts()["qmatmul_exact"] == 1 + sum(
        m > 0 for m, _, _ in GEMM_SHAPES)


@pytest.mark.parametrize("w_zp,out_dtype", [(0, torch.int8),
                                            (3, torch.uint8)])
def test_dwconv_ragged_channels_match_plain(dev, w_zp, out_dtype):
    """C = 13 (not a multiple of the strip kernel's 4-channel vector): the
    plan takes the general loop; exact and fast, stride 1 and 2,
    byte-equal."""
    rng = np.random.default_rng(21)
    args = _args(out_dtype, "double", w_zp)
    fast = _fast_args(out_dtype, w_zp)
    x = _i8(rng, dev, 2, 11, 9, 13)
    wd = _i8(rng, dev, 9, 13)
    epi = _epilogue(rng, 13, 9, dev)
    mult = torch.from_numpy(rng.uniform(2e-3, 8e-3, 13).astype(
        np.float32)).to(dev)
    K.reset_launches()
    for st, pad in (((1, 1), ((1, 1), (1, 1))), ((2, 2), ((0, 1), (0, 1)))):
        conv = dict(kh=3, kw=3, stride=st, dilation=(1, 1), padding=pad,
                    x_zp=-7)
        oh = (11 + sum(pad[0]) - 3) // st[0] + 1
        ow = (9 + sum(pad[1]) - 3) // st[1] + 1
        plan = QD.dwconv_plan(2, oh, ow, 13, 1, 3, 3, st, (1, 1), 16)
        assert plan.variant < 0 and plan.vec == 1, plan
        assert torch.equal(K.qdwconv2d_exact(x, wd, *epi, **conv, **args),
                           K.qdwconv2d_plain(x, wd, *epi, **conv, **args))
        assert torch.equal(
            K.qdwconv2d_fast(x, wd, epi[0], mult, **conv, **fast),
            K.qdwconv2d_fast_plain(x, wd, epi[0], mult, **conv, **fast))
    counts = K.launch_counts()
    assert counts["qdwconv2d_exact"] == 2 and counts["qdwconv2d_fast"] == 2


def _fast_args(out_dtype, w_zp):
    args = _args(out_dtype, "ruy", w_zp)
    del args["rounding"]
    return args


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("w_zp,out_dtype", [(0, torch.int8),
                                            (5, torch.uint8)])
def test_fast_kernels_match_plain(dev, per_channel, w_zp, out_dtype):
    """The fast-numerics instances, byte-equal to their plain versions:
    ragged K, mult 0.5 on odd sums (ties to even), and sums above 2^24."""
    rng = np.random.default_rng(19)
    args = _fast_args(out_dtype, w_zp)

    def mult(n, value=None):
        m = (np.full(n, value) if value is not None
             else rng.uniform(2e-4, 2e-3, n)).astype(np.float32)
        return torch.from_numpy(m[: n if per_channel else 1]).to(dev)

    def bias(n):
        return torch.from_numpy(
            rng.integers(-20000, 20000, n).astype(np.int32)).to(dev)

    K.reset_launches()
    a, b = _i8(rng, dev, 70, 27), _i8(rng, dev, 27, 20)
    bi = bias(20)
    for m in (mult(20), mult(20, 0.5)):
        assert torch.equal(K.qmatmul_fast(a, b, bi, m, **args),
                           K.qmatmul_fast_plain(a, b, bi, m, **args))
    big = torch.full((40, 1536), 120, dtype=torch.int8, device=dev)
    wb = torch.full((1536, 8), 110, dtype=torch.int8, device=dev)
    m, bi = mult(8, 2e-6), bias(8)  # ~40 units: rounded, not clamped
    assert torch.equal(K.qmatmul_fast(big, wb, bi, m, **args),
                       K.qmatmul_fast_plain(big, wb, bi, m, **args))
    x = _i8(rng, dev, 2, 9, 10, 4)
    wk = _i8(rng, dev, 9 * 4, 20)
    conv = dict(args, kh=3, kw=3, stride=(2, 1), dilation=(1, 2),
                padding=((1, 1), (2, 2)), x_zp=-6)
    m, bi = mult(20), bias(20)
    assert torch.equal(K.qconv2d_fast(x, wk, bi, m, **conv),
                       K.qconv2d_fast_plain(x, wk, bi, m, **conv))
    wd = _i8(rng, dev, 9, 8)
    dw = dict(args, kh=3, kw=3, stride=(2, 2), padding=((0, 1), (0, 1)),
              x_zp=4, dilation=(1, 1))
    m, bi = mult(8), bias(8)
    assert torch.equal(K.qdwconv2d_fast(x, wd, bi, m, **dw),
                       K.qdwconv2d_fast_plain(x, wd, bi, m, **dw))
    for i, (mm, k, n) in enumerate(GEMM_SHAPES):
        a, b = _gemm_operands(rng, dev, i, mm, k, n)
        # map the accumulator's spread to ~30 units
        m = torch.from_numpy((30.0 / (np.sqrt(k) * 73.0 * 73.0) * rng.uniform(
            0.5, 2.0, n if per_channel else 1)).astype(np.float32)).to(dev)
        bi = bias(n)
        got = K.qmatmul_fast(a, b, bi, m, **args)
        want = K.qmatmul_fast_plain(a, b, bi, m, **args)
        assert torch.equal(got, want), (mm, k, n, K.gemm_plan(mm, n, k))
    counts = K.launch_counts()
    assert counts["qmatmul_fast"] == 3 + sum(m > 0 for m, _, _ in GEMM_SHAPES)
    assert counts["qconv2d_fast"] == 1 and counts["qdwconv2d_fast"] == 1
    assert counts["qmatmul_exact"] == 0


def test_quantize_on_the_card_matches_the_cpu(dev):
    """QUANTIZE's float32 division on the card gives the CPU's bytes on
    exact ties k + 0.5 of the scale and their float32 neighbours (a
    multiply by the reciprocal would flip ~5% of them)."""
    rng = np.random.default_rng(20)
    s = np.float32(0.0371)
    ties = ((np.arange(-3000, 3000) + 0.5) * s).astype(np.float32)
    x = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                        np.nextafter(ties, np.float32(-np.inf)),
                        rng.normal(0, 4, 20000).astype(np.float32)])
    for dtype, zp in ((np.int8, -7), (np.uint8, 131)):
        cpu = Q.quantize(torch.from_numpy(x), float(s), zp, dtype)
        card = Q.quantize(torch.from_numpy(x).to(dev), float(s), zp, dtype)
        assert torch.equal(card.cpu(), cpu)
        q = cpu.to(dev)
        assert torch.equal(Q.dequantize(q, float(s), zp).cpu(),
                           Q.dequantize(cpu, float(s), zp))


@pytest.mark.parametrize("depth,in_dtype", [(1000, torch.int8),
                                            (10, torch.uint8)])
def test_softmax_kernel_matches_plain(dev, depth, in_dtype):
    rng = np.random.default_rng(18)
    lo, hi = (-128, 128) if in_dtype == torch.int8 else (0, 256)
    x = torch.from_numpy(rng.integers(lo, hi, (5, depth))).to(in_dtype).to(
        dev)
    table = torch.from_numpy(Q.softmax_table(0.0625, 1.0)).to(dev)
    zp = -128 if in_dtype == torch.int8 else 0
    assert torch.equal(K.lut_softmax(x, table, 1.0 / 256, zp, in_dtype),
                       K.lut_softmax_plain(x, table, 1.0 / 256, zp,
                                           in_dtype))


def _forced(module, planner, plan):
    """Run with ``module.<planner>`` returning ``plan`` for every call."""
    class Forced:
        def __enter__(self):
            self.saved = getattr(module, planner)
            setattr(module, planner, lambda *a: plan)

        def __exit__(self, *exc):
            setattr(module, planner, self.saved)
    return Forced()


# (n, h, w, ci, oc, stride, padding, x's byte offset in its buffer): the
# stem and small-Ci shapes of the slice models' convs, Ci 1 and 16 too,
# and x one byte off alignment
CONV_GEOMS = [
    (2, 13, 12, 1, 16, (2, 2), ((0, 1), (0, 1)), 0),
    (2, 13, 12, 3, 32, (2, 2), ((0, 1), (0, 1)), 0),
    (1, 10, 9, 8, 16, (1, 1), ((1, 1), (1, 1)), 0),
    (2, 9, 11, 16, 16, (1, 1), ((1, 1), (1, 1)), 0),
    (2, 9, 11, 16, 48, (2, 1), ((1, 1), (1, 1)), 1),
    (1, 12, 10, 3, 24, (1, 1), ((1, 1), (1, 1)), 1),
]


@pytest.mark.parametrize("geom", CONV_GEOMS)
@pytest.mark.parametrize("w_zp,out_dtype", [(0, torch.int8),
                                            (3, torch.uint8)])
def test_conv_plan_branches_match_plain(dev, geom, w_zp, out_dtype):
    """B2 and its fast instance under conv_plan's own plan, every direct
    variant forced onto a ragged tile, the mma branch forced with each N
    tile, and qgemm.cuh's loop forced: byte-equal to the plain
    versions."""
    n, h, w, ci, oc, st, pad, offset = geom
    rng = np.random.default_rng(23 + ci + oc)
    x = _i8(rng, dev, n * h * w * ci + offset)[offset:].view(n, h, w, ci)
    wk = _i8(rng, dev, 9 * ci, oc)
    epi = _epilogue(rng, oc, 9 * ci, dev)
    mult = torch.from_numpy((30.0 / (np.sqrt(9 * ci) * 73.0 * 73.0)
                             * rng.uniform(0.5, 2.0, oc)).astype(
                                 np.float32)).to(dev)
    conv = dict(kh=3, kw=3, stride=st, dilation=(1, 1), padding=pad,
                x_zp=-7)
    args = dict(_args(out_dtype, "double", w_zp), **conv)
    fast = dict(_fast_args(out_dtype, w_zp), **conv)
    want = K.qconv2d_plain(x, wk, *epi, **args)
    want_fast = K.qconv2d_fast_plain(x, wk, epi[0], mult, **fast)
    oh = (h + sum(pad[0]) - 3) // st[0] + 1
    ow = (w + sum(pad[1]) - 3) // st[1] + 1
    th, tw = QC.mma_tile(QC.MMA_PIXELS[0])
    plans = [QC.conv_plan(n, oh, ow, ci, oc, 3, 3, st, (1, 1),
                          QC.alignment(wk)),
             QC.loop_plan(n, oh, ow, oc)]
    plans += [QC.mma_plan(v, n, oh, ow, oc, 3, 3, st, (1, 1), th, tw, 1)
              for v in range(len(QC.MMA_NTILES))]
    plans += [p for p in (QC.direct_plan(v, n, oh, ow, ci, oc, 3, 3, st,
                                         (1, 1), 2, 4)
                          for v in range(len(QC.DIRECT_VARIANTS)))
              if QC.fits(p, ci, oc)]
    assert plans[0].branch == "direct"
    assert len(plans) == 2 + len(QC.MMA_NTILES) + len(QC.DIRECT_VARIANTS)
    K.reset_launches()
    for plan in plans:
        with _forced(QC, "conv_plan", plan):
            got = K.qconv2d_exact(x, wk, *epi, **args)
            got_fast = K.qconv2d_fast(x, wk, epi[0], mult, **fast)
        assert torch.equal(got, want), plan
        assert torch.equal(got_fast, want_fast), plan
    counts = K.launch_counts()
    assert counts["qconv2d_exact"] == counts["qconv2d_fast"] == len(plans)


# (n, h, w, ci, oc, kh, kw, stride, dilation, padding, x's byte offset):
# FSRCNN's union deconv and 3x3 12 -> 12 conv at full width, a ragged Ci
# with x off alignment, Oc 65 and 200 (column tiles on grid y), stride 2,
# dilation 2, a block above 48 KB of shared memory (the opt-in), Ci 200
# in three channel groups, K of 147,456 bytes (Ci 16384) in channel
# groups each below 2^17 bytes, taps 54 apart (only an N tile of 8 fits
# Oc 32) and taps 60 apart (no patch fits: a gathering block)
MMA_GEOMS = [
    (1, 360, 640, 56, 4, 5, 5, (1, 1), (1, 1), ((2, 2), (2, 2)), 0),
    (1, 360, 640, 12, 12, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 0),
    (2, 13, 11, 5, 9, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 1),
    (1, 17, 19, 27, 65, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 0),
    (1, 12, 14, 32, 200, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 0),
    (2, 21, 19, 24, 16, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1)), 0),
    (1, 20, 22, 20, 24, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2)), 0),
    (1, 200, 200, 16, 32, 11, 11, (1, 1), (1, 1), ((5, 5), (5, 5)), 3),
    (1, 9, 70, 200, 32, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 0),
    (1, 5, 7, 16384, 24, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1)), 0),
    (1, 130, 130, 32, 32, 3, 3, (1, 1), (54, 54), ((54, 54), (54, 54)), 0),
    (1, 130, 130, 32, 16, 3, 3, (1, 1), (60, 60), ((60, 60), (60, 60)), 0),
]


@pytest.mark.parametrize("geom", MMA_GEOMS, ids=lambda g: "x".join(
    map(str, g[:5])) + f"-{g[5]}x{g[6]}-s{g[7][0]}-d{g[8][0]}")
@pytest.mark.parametrize("w_zp,out_dtype", [(0, torch.int8),
                                            (3, torch.uint8)])
def test_mma_branch_matches_plain(dev, geom, w_zp, out_dtype):
    """The general branch (csrc/qconv_mma.cuh) under conv_plan's plan,
    with each N tile forced where it fits, and as a gathering block,
    exact and fast numerics, byte-equal to the plain versions."""
    n, h, w, ci, oc, kh, kw, st, dil, pad, offset = geom
    rng = np.random.default_rng(ci + oc + kh)
    x = _i8(rng, dev, n * h * w * ci + offset)[offset:].view(n, h, w, ci)
    wk = _i8(rng, dev, kh * kw * ci, oc)
    epi = _epilogue(rng, oc, kh * kw * ci, dev)
    mult = torch.from_numpy((30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0)
                             * rng.uniform(0.5, 2.0, oc)).astype(
                                 np.float32)).to(dev)
    conv = dict(kh=kh, kw=kw, stride=st, dilation=dil, padding=pad,
                x_zp=-68)
    oh = QC.conv_out_size(h, kh, st[0], dil[0], sum(pad[0]))
    ow = QC.conv_out_size(w, kw, st[1], dil[1], sum(pad[1]))
    plan = QC.conv_plan(n, oh, ow, ci, oc, kh, kw, st, dil, QC.alignment(wk))
    assert plan.branch == "mma", plan
    if kh == 11:
        assert plan.smem > QC.MAX_SMEM, plan
    assert plan.gather == (dil[0] == 60), plan
    if dil[0] == 54:
        assert QC.MMA_NTILES[plan.variant] == 8, plan
    th, tw = plan.tile
    plans = [plan] + [
        p for p in (QC.mma_plan(v, n, oh, ow, oc, kh, kw, st, dil, th, tw,
                                plan.slabs, gather)
                    for v in range(len(QC.MMA_NTILES))
                    for gather in (False, True))
        if QC.mma_fits(p, ci, kh, kw)]
    args = dict(_args(out_dtype, "ruy", w_zp), **conv)
    fast = dict(_fast_args(out_dtype, w_zp), **conv)
    want = K.qconv2d_plain(x, wk, *epi, **args)
    want_fast = K.qconv2d_fast_plain(x, wk, epi[0], mult, **fast)
    for p in plans:
        with _forced(QC, "conv_plan", p):
            got = K.qconv2d_exact(x, wk, *epi, **args)
            got_fast = K.qconv2d_fast(x, wk, epi[0], mult, **fast)
        assert torch.equal(got, want), p
        assert torch.equal(got_fast, want_fast), p


@pytest.mark.parametrize("w_zp", [0, 3])
def test_mma_branch_k_beyond_2_17_wraps_as_plain(dev, w_zp):
    """K of 147,456 bytes with every x, x_zp and weight at -128: the sum,
    9 * 16384 * 2^14 = 2,415,919,104, leaves int32.  Each channel group
    stays below 2^17 bytes of K, so the tensor cores' int32 sums are
    exact, and the groups add modulo 2^32: exact and fast outputs
    byte-equal to the plain versions' int32 wrap."""
    n, h, w, ci, oc = 1, 5, 7, 16384, 24
    x = torch.full((n, h, w, ci), -128, dtype=torch.int8, device=dev)
    wk = torch.full((9 * ci, oc), -128, dtype=torch.int8, device=dev)
    rng = np.random.default_rng(217)
    epi = _epilogue(rng, oc, 9 * ci, dev)
    mult = torch.full((oc,), 1e-9, dtype=torch.float32, device=dev)
    conv = dict(kh=3, kw=3, padding=((1, 1), (1, 1)), x_zp=-128)
    plan = QC.conv_plan(n, h, w, ci, oc, 3, 3, (1, 1), (1, 1),
                        QC.alignment(wk))
    assert plan.branch == "mma" and plan.slabs < 1024, plan
    args = dict(_args(torch.int8, "ruy", w_zp), **conv)
    fast = dict(_fast_args(torch.int8, w_zp), **conv)
    assert torch.equal(K.qconv2d_exact(x, wk, *epi, **args),
                       K.qconv2d_plain(x, wk, *epi, **args))
    assert torch.equal(K.qconv2d_fast(x, wk, epi[0], mult, **fast),
                       K.qconv2d_fast_plain(x, wk, epi[0], mult, **fast))


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("depth", [10, 1000])
@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.int8, torch.int8),
                                                (torch.uint8, torch.uint8)])
def test_softmax_plan_branches_match_plain(dev, rows, depth, in_dtype,
                                           out_dtype):
    """The softmax kernel under softmax_plan's plan, the thread kernel
    and the row kernel forced (32, 64 and 256 threads), with x one byte
    off alignment too: byte-equal to the plain version."""
    rng = np.random.default_rng(24 + depth + rows)
    lo, hi = (-128, 128) if in_dtype == torch.int8 else (0, 256)
    table = torch.from_numpy(Q.softmax_table(0.05, 1.0)).to(dev)
    zp = -128 if out_dtype == torch.int8 else 0
    plans = [SM.softmax_plan(rows, depth), SM.thread_plan(rows)] + [
        SM.row_plan(rows, depth, t) for t in (32, 64, 256)]
    K.reset_launches()
    for offset in (0, 1):
        buf = torch.from_numpy(rng.integers(lo, hi, rows * depth + offset)
                               ).to(in_dtype).to(dev)
        x = buf[offset:].view(rows, depth)
        want = K.lut_softmax_plain(x, table, 1.0 / 256, zp, out_dtype)
        for plan in plans:
            with _forced(SM, "softmax_plan", plan):
                got = K.lut_softmax(x, table, 1.0 / 256, zp, out_dtype)
            assert torch.equal(got, want), (plan, offset)
    assert K.launch_counts()["lut_softmax"] == 2 * len(plans)


def _golden_inputs(z, name, td, key="output"):
    """tests/gen_torch_goldens.py's (or gen_torch_fast_goldens.py's)
    inputs of ``name``, regenerated from their seed (this file imports
    nothing of the tests package) and checked against the digest the
    generator stored."""
    import hashlib

    info = np.iinfo(td.dtype)
    n = len(z[f"{name}/{key}"])
    xs = np.random.default_rng(int(z[f"{name}/seed"])).integers(
        info.min, info.max + 1, size=(n, *td.shape), dtype=np.int64
    ).astype(td.dtype)
    assert hashlib.sha256(xs.tobytes()).hexdigest() == str(
        z[f"{name}/input_sha"])
    return xs


def test_gpu_worker_serves_the_goldens(dev):
    z = np.load(os.path.join(DATA, "torch_goldens.npz"))
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=4))
           .build())
    eng = bt.Engine.create(cfg)
    try:
        mid = eng.register_model(
            bt.Model.from_path(os.path.join(DATA, "fc_int8.tflite")))
        g = eng.model_record(mid).model.graph
        td = g.tensor(g.inputs[0])
        want = z["fc_int8/output"]
        xs = _golden_inputs(z, "fc_int8", td)
        K.reset_launches()
        ids = [eng.request_async(mid, [x]) for x in xs]
        for i, j in enumerate(ids):
            np.testing.assert_array_equal(eng.wait(j)[0], want[i])
        assert K.launch_counts()["qmatmul_exact"] > 0
    finally:
        eng.shutdown()


def test_gpu_worker_serves_the_fast_goldens(dev):
    """numerics="fast" on a GPU worker: quant_act_int8 and fc_int8 give
    the fast goldens (tests/gen_torch_fast_goldens.py) through the fast
    kernels."""
    zf = np.load(os.path.join(DATA, "torch_fast_goldens.npz"))
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=4))
           .numerics("fast")
           .build())
    eng = bt.Engine.create(cfg)
    try:
        K.reset_launches()
        for name in ("quant_act_int8", "fc_int8"):
            mid = eng.register_model(
                bt.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
            g = eng.model_record(mid).model.graph
            xs = _golden_inputs(zf, name, g.tensor(g.inputs[0]),
                                key="fast_output0")
            ids = [eng.request_async(mid, [x]) for x in xs]
            for i, j in enumerate(ids):
                for o, out in enumerate(eng.wait(j)):
                    np.testing.assert_array_equal(
                        out, zf[f"{name}/fast_output{o}"][i])
        assert K.launch_counts()["qmatmul_fast"] > 0
        assert K.launch_counts()["qmatmul_exact"] == 0
    finally:
        eng.shutdown()


def _fsrcnn_general_geoms():
    """FSRCNN x2's (360x640) convs that take B2's general branch: the four
    3x3 12 -> 12 mapping convs (Oc not a multiple of 8) and the deconv's
    union conv of its four sub-pixel phases (Ci 56, Oc 4), with the
    padding the lowering gives it: (kh, kw, ci, oc, ((top, bottom), (left,
    right)))."""
    from band_tpu_torch.ops.lowerings import _tconv_phases, _tconv_window

    h, w = 360, 640
    _, uh, pads_h, _, _ = _tconv_window(_tconv_phases(9, 2, 3, 2 * h), h)
    _, uw, pads_w, _, _ = _tconv_window(_tconv_phases(9, 2, 3, 2 * w), w)
    return [(3, 3, 12, 12, ((1, 1), (1, 1))),
            (uh, uw, 56, 4, (pads_h, pads_w))]


@pytest.mark.parametrize("geom", _fsrcnn_general_geoms(),
                         ids=lambda g: f"{g[0]}x{g[1]}-ci{g[2]}-oc{g[3]}")
@pytest.mark.parametrize("rounding", ["ruy", "double"])
def test_fsrcnn_general_branch_shapes_match_plain(dev, geom, rounding):
    """B2 and B2 fast at FSRCNN's full-width general-branch shapes (the
    plan picks the mma branch), byte-equal to the plain versions."""
    kh, kw, ci, oc, pad = geom
    h, w = 360, 640
    rng = np.random.default_rng(kh * 10 + kw + ci)
    x = _i8(rng, dev, 1, h, w, ci)
    wk = _i8(rng, dev, kh * kw * ci, oc)
    epi = _epilogue(rng, oc, kh * kw * ci, dev)
    mult = torch.from_numpy((30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0)
                             * rng.uniform(0.5, 2.0, oc)).astype(
                                 np.float32)).to(dev)
    conv = dict(kh=kh, kw=kw, padding=pad, x_zp=-68)
    oh = h + sum(pad[0]) - kh + 1
    ow = w + sum(pad[1]) - kw + 1
    assert (oh, ow) == (h, w)
    assert QC.conv_plan(1, oh, ow, ci, oc, kh, kw, (1, 1), (1, 1),
                        QC.alignment(wk)).branch == "mma"
    args = dict(_args(torch.int8, rounding, 0), **conv)
    got = K.qconv2d_exact(x, wk, *epi, **args)
    assert torch.equal(got, K.qconv2d_plain(x, wk, *epi, **args))
    fast = dict(_fast_args(torch.int8, 0), **conv)
    assert torch.equal(K.qconv2d_fast(x, wk, epi[0], mult, **fast),
                       K.qconv2d_fast_plain(x, wk, epi[0], mult, **fast))


def test_gpu_worker_serves_fsrcnn_small(dev):
    """FSRCNN x2 at 24x40 on a GPU worker, exact and fast side by side:
    TFLite's outputs and band_tpu's fast outputs
    (tests/data/torch_ops_goldens.npz), through B1, B2 and their fast
    instances."""
    z = np.load(os.path.join(DATA, "torch_ops_goldens.npz"))
    name = "fsrcnn_x2_small_int8"
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=4))
           .build())
    eng = bt.Engine.create(cfg)
    try:
        path = os.path.join(DATA, f"{name}.tflite")
        exact = eng.register_model(bt.Model.from_path(path))
        fast = eng.register_model(bt.Model.from_path(path), numerics="fast")
        g = eng.model_record(exact).model.graph
        xs = _golden_inputs(z, name, g.tensor(g.inputs[0]), key="exact0")
        K.reset_launches()
        for mid, key in ((exact, "exact0"), (fast, "fast0")):
            ids = [eng.request_async(mid, [x]) for x in xs]
            for i, j in enumerate(ids):
                np.testing.assert_array_equal(eng.wait(j)[0],
                                              z[f"{name}/{key}"][i])
        counts = K.launch_counts()
        for kernel in ("qmatmul_exact", "qconv2d_exact", "qmatmul_fast",
                       "qconv2d_fast"):
            assert counts[kernel] > 0, kernel
    finally:
        eng.shutdown()


def test_general_branch_beyond_65535_row_tiles(dev):
    """B2's general branch on 72 stacked FSRCNN frames (16,588,800 output
    pixels: 66,240 pixel tiles of 16 x 16, above grid y's 65,535), and
    qgemm.cuh's loop forced on 19 of them (4,377,600 output pixels:
    68,400 row tiles of 64), exact and fast, byte-equal to the plain
    versions."""
    rng = np.random.default_rng(19)
    x = _i8(rng, dev, 72, 360, 640, 12)
    wk = _i8(rng, dev, 9 * 12, 12)
    epi = _epilogue(rng, 12, 9 * 12, dev)
    mult = torch.full((12,), 1e-3, dtype=torch.float32, device=dev)
    conv = dict(kh=3, kw=3, padding=((1, 1), (1, 1)), x_zp=-92)
    plan = QC.conv_plan(72, 360, 640, 12, 12, 3, 3, (1, 1), (1, 1),
                        QC.alignment(wk))
    assert plan.branch == "mma" and plan.grid == (66240, 1, 1), plan
    args = dict(_args(torch.int8, "ruy", 0), **conv)
    assert torch.equal(K.qconv2d_exact(x, wk, *epi, **args),
                       K.qconv2d_plain(x, wk, *epi, **args))
    fast = dict(_fast_args(torch.int8, 0), **conv)
    assert torch.equal(K.qconv2d_fast(x, wk, epi[0], mult, **fast),
                       K.qconv2d_fast_plain(x, wk, epi[0], mult, **fast))
    x = x[:19]
    loop = QC.loop_plan(19, 360, 640, 12)
    assert loop.grid[0] == 68400
    with _forced(QC, "conv_plan", loop):
        got = K.qconv2d_exact(x, wk, *epi, **args)
        got_fast = K.qconv2d_fast(x, wk, epi[0], mult, **fast)
    assert torch.equal(got, K.qconv2d_plain(x, wk, *epi, **args))
    assert torch.equal(got_fast,
                       K.qconv2d_fast_plain(x, wk, epi[0], mult, **fast))


# --------------------------------------------------------------------------
# float32 and dynamic-range models: the hybrid GEMM and the TF32 rule
# --------------------------------------------------------------------------

# (M, K, N, rows): M = 1 and 8 (b1, b8 FCs; K split), 49 to 12544 (1x1
# convs of a request's H*W rows), K 8 (one step, ragged) to 8192, N
# ragged (27) and 1000; rows > 1 group a 1x1 conv's pixels by request
HYBRID_SHAPES = [(1, 1280, 1000, 1), (8, 1280, 1000, 1), (1, 8192, 64, 1),
                 (3, 8, 27, 1), (49, 960, 160, 49), (392, 320, 1280, 49),
                 (784, 144, 24, 196), (12544, 16, 96, 12544),
                 (17, 24, 16, 17), (33, 27, 40, 11)]


@pytest.mark.parametrize("m,k,n,rows", HYBRID_SHAPES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("form", ["asym", "sym"])
def test_hybrid_gemm_matches_plain(dev, m, k, n, rows, form):
    """qmatmul_hybrid byte-equal to qmatmul_hybrid_plain over each shape,
    every fused activation, with and without bias, symmetric and
    asymmetric rows (a zero row among them)."""
    rng = np.random.default_rng(m * 7 + k + n)
    a = _i8(rng, dev, m, k)
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
        np.int8)).to(dev)
    w_scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(
        np.float32)).to(dev)
    rowsum = b.to(torch.int32).sum(dim=0).to(torch.int32)
    groups = m // rows
    scale = torch.from_numpy(rng.uniform(1e-3, 0.1, groups).astype(
        np.float32)).to(dev)
    zp = None
    if form == "asym":
        zp = torch.from_numpy(rng.integers(-128, 128, groups).astype(
            np.float32)).to(dev)
        zp[0] = 0.0
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    K.reset_launches()
    runs = 0
    for act in ("NONE", "RELU", "RELU6"):
        for bb in (None, bias):
            got = K.qmatmul_hybrid(a, b, w_scale, rowsum, zp, scale, bb,
                                   rows=rows, activation=act)
            want = K.qmatmul_hybrid_plain(a, b, w_scale, rowsum, zp, scale,
                                          bb, rows=rows, activation=act)
            assert got.dtype == torch.float32 and got.shape == (m, n)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            runs += 1
    assert K.launch_counts()["qmatmul_hybrid"] == runs


# (n, h, w, ci, oc, taps, pads): FSRCNN's union deconv at full width (b1)
# and at 24x40 (b3), ragged channels, uneven pads, several channel groups
HYBRID_CONV_SHAPES = [(1, 360, 640, 56, 4, 5, ((2, 2), (2, 2))),
                      (3, 24, 40, 56, 4, 5, ((2, 2), (2, 2))),
                      (2, 17, 33, 20, 12, 3, ((1, 0), (2, 1))),
                      (2, 20, 20, 130, 70, 3, ((1, 1), (1, 1)))]


@pytest.mark.parametrize("geom", HYBRID_CONV_SHAPES, ids=lambda v: str(v))
def test_hybrid_conv_matches_plain(dev, geom):
    """qconv2d_hybrid byte-equal to qconv2d_hybrid_plain, with and without
    bias, each image's padded taps its own zero point (one image's zp
    -128, one 127)."""
    n, h, w, ci, oc, k, pads = geom
    rng = np.random.default_rng(n * 131 + ci + oc)
    x = _i8(rng, dev, n, h, w, ci)
    wk = torch.from_numpy(rng.integers(-127, 128, (k * k * ci, oc)).astype(
        np.int8)).to(dev)
    colsum = wk.to(torch.int64).sum(dim=0).to(torch.int32)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, oc).astype(
        np.float32)).to(dev)
    zp = rng.integers(-128, 128, n).astype(np.float32)
    zp[0], zp[-1] = -128.0, 127.0 if n > 1 else -128.0
    zp = torch.from_numpy(zp).to(dev)
    sc = torch.from_numpy(rng.uniform(1e-3, 5e-2, n).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(oc).astype(np.float32)).to(dev)
    K.reset_launches()
    for b in (None, bias):
        got = K.qconv2d_hybrid(x, wk, ws, colsum, zp, sc, b, kh=k, kw=k,
                               padding=pads)
        want = K.qconv2d_hybrid_plain(x, wk, ws, colsum, zp, sc, b, kh=k,
                                      kw=k, padding=pads)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert K.launch_counts()["qconv2d_hybrid"] == 2


def _float_engine(max_batch=4):
    return bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU, device_ids=(0,),
                                  max_batch=max_batch))
        .build())


@pytest.fixture
def tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def test_tf32_rule_on_the_card(dev, tf32_flags):
    """With torch.backends.cudnn.allow_tf32 on, a float model's program for
    the card is refused with a LoweringError naming the flag (the
    library changes no flag); with it off the model serves; turned on
    after the build, the run raises."""
    from band_tpu_torch.backend.executor import ModelExecutor
    from band_tpu_torch.errors import LoweringError

    g = bt.Model.from_path(os.path.join(DATA, "fp16_cnn.tflite")).graph
    x = np.random.default_rng(0).uniform(
        -1.0, 1.0, g.tensor(g.inputs[0]).shape).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ex = ModelExecutor(0, g, 0, dev)
    with pytest.raises(LoweringError, match=r"cudnn\.allow_tf32"):
        ex.prepare_subgraph(range(len(g.ops)), [0])
    assert torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    out = ex.execute(key, [x])[0].cpu().numpy()
    cpu = ModelExecutor(1, g, 0, torch.device("cpu"))
    ckey = cpu.prepare_subgraph(range(len(g.ops)), [0])
    np.testing.assert_allclose(out, cpu.execute(ckey, [x])[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(LoweringError, match=r"cudnn\.allow_tf32"):
        ex.execute(key, [x])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.raises(LoweringError, match=r"matmul\.allow_tf32"):
        ex.execute(key, [x])


def test_gpu_worker_serves_the_float_goldens(dev, tf32_flags):
    """fp16_cnn and dynrange on a GPU worker within the card's gate of
    their goldens (tests/data/torch_float_goldens.npz), the hybrid FC on
    qmatmul_hybrid."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    z = np.load(os.path.join(DATA, "torch_float_goldens.npz"))
    eng = _float_engine()
    try:
        K.reset_launches()
        for name in ("fp16_cnn", "dynrange"):
            mid = eng.register_model(
                bt.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
            g = eng.model_record(mid).model.graph
            want, band = z[f"{name}/tflite"], z[f"{name}/dev"]
            xs = np.random.default_rng(int(z[f"{name}/seed"])).uniform(
                -1.0, 1.0, (len(want), *g.tensor(g.inputs[0]).shape)
            ).astype(np.float32)
            ids = [eng.request_async(mid, [x]) for x in xs]
            for i, j in enumerate(ids):
                out = eng.wait(j)[0]
                d = float(np.abs(out.astype(np.float64) - want[i]).max())
                assert out.argmax() == want[i].argmax()
                assert d <= max(2 * band[i], 1e-4 * np.abs(want[i]).max())
        assert K.launch_counts()["qmatmul_hybrid"] > 0
        assert K.launch_counts()["qmatmul_exact"] == 0
    finally:
        eng.shutdown()


def test_gpu_worker_serves_fsrcnn_small_float(dev, tf32_flags):
    """FSRCNN x2 at 24x40 in float32 and dynamic range on a GPU worker:
    each output within 1e-4 x max|out| of the same request on a CPU
    worker (every kernel's plain version) in float32; within 1e-3 x
    max|out| with dynamic range, where cuDNN's float 1x1 convs differ
    from the CPU's in the last bit and a deconv input sitting on a
    rounding boundary flips its code, moving its 9x9 reach by up to
    ~5e-4 x max (tests/test_torch_srfloat.py::
    test_dynrange_fsrcnn_matches_tflite); the hybrid deconv on
    qconv2d_hybrid."""
    from band_tpu_torch.backend.executor import ModelExecutor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    eng = _float_engine()
    try:
        for name in ("fsrcnn_x2_small_float", "fsrcnn_x2_small_dynrange"):
            mid = eng.register_model(
                bt.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
            g = eng.model_record(mid).model.graph
            cpu = ModelExecutor(1, g, 0, torch.device("cpu"))
            key = cpu.prepare_subgraph(range(len(g.ops)), [0])
            xs = rng.uniform(0, 1, (4, *g.tensor(g.inputs[0]).shape)).astype(
                np.float32)
            K.reset_launches()
            ids = [eng.request_async(mid, [x]) for x in xs]
            for x, j in zip(xs, ids):
                out = eng.wait(j)[0]
                want = cpu.execute(key, [x])[0].numpy()
                d = float(np.abs(out.astype(np.float64) - want).max())
                rel = 1e-3 if name.endswith("dynrange") else 1e-4
                assert d <= rel * float(np.abs(want).max())
            hybrid = name.endswith("dynrange")
            assert (K.launch_counts()["qconv2d_hybrid"] > 0) == hybrid
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# the support op set and the request axis on the card (CenterNet)
# --------------------------------------------------------------------------

def _detect_goldens(name, side):
    """centernet goldens (tests/gen_torch_centernet_model.py): the
    regenerated int8 inputs (uniform over [-128, 127] from the stored
    seed) and, per numerics, the outputs by request."""
    import hashlib

    z = np.load(os.path.join(DATA, "torch_detect_goldens.npz"))
    rng = np.random.default_rng(int(z[f"{name}/seed"]))
    xs = rng.integers(-128, 128, size=(8, 1, side, side, 3),
                      dtype=np.int64).astype(np.int8)
    assert hashlib.sha256(xs.tobytes()).hexdigest() == str(
        z[f"{name}/input_sha"])
    return xs, {kind: [z[f"{name}/{kind}{j}"] for j in range(3)]
                for kind in ("exact", "fast")}


@pytest.mark.parametrize("name,n", [("centernet_small_int8", 2048),
                                    ("centernet_mnv2_fpn_int8", 1474560)])
def test_topk_ties_on_the_card(dev, name, n):
    """TOPK_V2 of the detector's decode on the card: an all-tied heatmap
    row gives indices 0..k-1 in order; a window of rows tied at other
    values, and rows of three distinct values, give the CPU's indices
    (lower index first among equal values) and values."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.tflite.parser import parse_tflite_file

    g = parse_tflite_file(os.path.join(DATA, f"{name}.tflite"))
    op = next(o for o in g.ops if o.opname == "TOPK_V2")
    assert g.tensor(op.inputs[0]).shape == (1, n)
    k = int(np.asarray(g.tensor(op.inputs[1]).data).reshape(()))
    prog = build_program(g, [op.index], device=dev)
    fn = prog.make_fn()
    rng = np.random.default_rng(13)
    rows = [np.full((1, n), 0, np.int8),
            np.stack([np.full(n, v, np.int8) for v in (-128, 9, 127)]),
            rng.integers(-1, 2, (4, n)).astype(np.int8)]
    for row in rows:
        vals, idx = fn(params_from_jax(prog.params, dev),
                       [torch.from_numpy(row).to(dev)])
        cvals, cidx = fn(params_from_jax(prog.params),
                         [torch.from_numpy(row)])
        np.testing.assert_array_equal(idx.cpu().numpy(), cidx.numpy())
        np.testing.assert_array_equal(vals.cpu().numpy(), cvals.numpy())
        for b in range(row.shape[0]):
            order = np.lexsort((np.arange(n), -row[b].astype(np.int64)))
            np.testing.assert_array_equal(idx[b].cpu().numpy(), order[:k])
    tied = fn(params_from_jax(prog.params, dev),
              [torch.zeros((1, n), dtype=torch.int8, device=dev)])[1]
    np.testing.assert_array_equal(tied.cpu().numpy()[0], np.arange(k))


def test_gpu_worker_serves_the_small_detector(dev):
    """centernet_small_int8 on a GPU worker, exact and fast side by side:
    every golden request at b1 and all eight in a burst, byte-equal to
    TFLite's and band_tpu's fast outputs; a b8 window in reversed order
    on the worker's executor equal to the goldens request by request."""
    name = "centernet_small_int8"
    xs, want = _detect_goldens(name, 64)
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=8))
           .build())
    eng = bt.Engine.create(cfg)
    try:
        path = os.path.join(DATA, f"{name}.tflite")
        mids = {"exact": eng.register_model(bt.Model.from_path(path)),
                "fast": eng.register_model(bt.Model.from_path(path),
                                           numerics="fast")}
        assert eng.wait_buckets_ready(timeout=300)
        for kind, mid in mids.items():
            sync = [eng.request_sync(mid, [x]) for x in xs]
            ids = [eng.request_async(mid, [x]) for x in xs]
            for i, outs in enumerate(sync + [eng.wait(j) for j in ids]):
                for j, o in enumerate(outs):
                    np.testing.assert_array_equal(
                        np.asarray(o), want[kind][j][i % len(xs)])
            ex = eng.model_record(mid).executors[0]
            key = ex.largest_subgraph_key()
            pos = [ex.output_ids(key).index(t)
                   for t in eng.model_record(mid).model.graph.outputs]
            order = list(reversed(range(len(xs))))
            outs = ex.execute_batched(key, [[xs[i]] for i in order])
            for i, o in zip(order, outs):
                for j, p in enumerate(pos):
                    np.testing.assert_array_equal(o[p].cpu().numpy(),
                                                  want[kind][j][i])
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# the exact ADD/SUB kernel (csrc/qaddsub.cu) against qaddsub_plain, the
# int64 chain, on the card
# --------------------------------------------------------------------------

def _addsub_kw(s1, s2, so, zp1, zp2, zpo, out_dtype, sign=1):
    """The scalars ops/lowerings.py _prepare_addsub gives for these
    scales and zero points (activation NONE)."""
    tm = 2.0 * max(s1, s2)
    qm1, sh1 = Q.quantize_multiplier(s1 / tm)
    qm2, sh2 = Q.quantize_multiplier(s2 / tm)
    qmo, sho = Q.quantize_multiplier(tm / ((1 << 20) * so))
    qmin, qmax = (0, 255) if out_dtype == torch.uint8 else (-128, 127)
    return dict(zp1=zp1, zp2=zp2, zpo=zpo, qm1=qm1, sh1=sh1, qm2=qm2,
                sh2=sh2, qmo=qmo, sho=sho, left_shift=20, qmin=qmin,
                qmax=qmax, sign=sign, out_dtype=out_dtype)


def _bytes(rng, dev, dtype, n, offset=0):
    """n random bytes as ``dtype`` on the card, ``offset`` bytes into
    their buffer."""
    b = torch.from_numpy(rng.integers(0, 256, n + offset).astype(np.uint8))
    return b.to(dev)[offset:].view(dtype)


def _pairs(dev, d1, d2):
    """All 65,536 pairs of input bytes."""
    b1, b2 = (torch.from_numpy(a.ravel().astype(np.uint8)).to(dev)
              for a in np.meshgrid(np.arange(256), np.arange(256)))
    return b1.view(d1), b2.view(d2)


def _held(x1, x2, kw, rounding=None):
    got = K.qaddsub(x1, x2, rounding=rounding, **kw)
    want = K.qaddsub_plain(x1, x2, rounding=rounding or Q.DEFAULT_ROUNDING,
                           **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [1, 7, 32])
def test_qaddsub_matches_plain_on_mobilenet_adds(dev, batch):
    """The ten ADDs of MobileNetV2 int8 with their prepared scalars, on
    random windows of ``batch`` requests: one launch each."""
    from band_tpu_torch.ops import lowerings as L

    g = bt.Model.from_path(os.path.join(DATA, "mobilenet_v2_int8.tflite")
                           ).graph
    adds = [op for op in g.ops if op.opname == "ADD"]
    assert len(adds) == 10
    rng = np.random.default_rng(batch)
    K.reset_launches()
    for op in adds:
        meta = L._prepare_addsub(g, op, True)
        shape = (batch,) + tuple(g.tensor(op.outputs[0]).shape[1:])
        x1, x2 = (_i8(rng, dev, *shape) for _ in range(2))
        kw = {k: int(meta[k]) for k in K.addsub.PARAMS}
        _held(x1, x2, dict(kw, sign=1, out_dtype=torch.int8))
    assert K.launch_counts()["qaddsub"] == 10


@pytest.mark.parametrize("n,off1,off2", [
    (1, 0, 0), (15, 0, 0), (17, 0, 0), (1001, 0, 0), (75264 + 7, 0, 0),
    (1000, 1, 0), (1000, 0, 1), (75264, 1, 3), (65536, 16, 16)])
def test_qaddsub_odd_counts_and_unaligned_views(dev, n, off1, off2):
    """Ragged tails, and operands one byte (or three) into their buffers:
    the byte-by-byte path; 16 bytes in: the vector path."""
    rng = np.random.default_rng(n + off1)
    x1 = _bytes(rng, dev, torch.int8, n, off1)
    x2 = _bytes(rng, dev, torch.int8, n, off2)
    _held(x1, x2, _addsub_kw(0.031, 0.017, 0.05, 3, -7, 5, torch.int8))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("d1,d2,do", [
    (torch.int8, torch.int8, torch.int8),
    (torch.uint8, torch.uint8, torch.uint8),
    (torch.int8, torch.uint8, torch.uint8)])
def test_qaddsub_every_byte_pair(dev, rounding, sign, d1, d2, do):
    """All 65,536 pairs of input bytes, ADD and SUB, int8 and uint8, under
    each rounding (the kernel takes it as an argument; the lowering reads
    Q.DEFAULT_ROUNDING)."""
    zp = {torch.int8: -2, torch.uint8: 130}
    x1, x2 = _pairs(dev, d1, d2)
    for s1, s2 in ((0.02, 0.02), (0.3, 0.004), (0.004, 0.3)):
        kw = _addsub_kw(s1, s2, 0.9 * max(s1, s2), zp[d1], zp[d2] + 1,
                        zp[do] + 2, do, sign)
        _held(x1, x2, kw, rounding)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("k", [0, 5, 10, 15, 20])
def test_qaddsub_extreme_multipliers(dev, rounding, k):
    """qm at and near 2^31 - 1 with the shifts Q.quantize_multiplier gives
    for scale ratios 2^-k (k up to 20), where the int64 products and the
    33-bit sums reach their largest; all 65,536 byte pairs."""
    x1, x2 = _pairs(dev, torch.int8, torch.int8)
    sh = Q.quantize_multiplier(2.0 ** -k * 0.999)[1]
    sho = Q.quantize_multiplier(2.0 ** (k - 20) * 0.999)[1]
    for qm in (2**31 - 1, 2**31 - 2, 2**30):
        kw = dict(zp1=-128, zp2=127, zpo=0, qm1=qm, sh1=sh, qm2=2**31 - 1,
                  sh2=0, qmo=qm, sho=sho, left_shift=20, qmin=-128,
                  qmax=127, out_dtype=torch.int8)
        for sign in (1, -1):
            _held(x1, x2, dict(kw, sign=sign), rounding)


def _mobilenet(dev):
    """MobileNetV2 int8 on an executor of its own, its golden inputs and
    outputs."""
    from band_tpu_torch.backend.executor import ModelExecutor

    z = np.load(os.path.join(DATA, "torch_goldens.npz"))
    g = bt.Model.from_path(os.path.join(DATA, "mobilenet_v2_int8.tflite")
                           ).graph
    ex = ModelExecutor(-2, g, 0, dev, exact=True)
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    xs = _golden_inputs(z, "mobilenet_v2_int8", g.tensor(g.inputs[0]))
    return ex, key, xs, z["mobilenet_v2_int8/output"]


def test_mobilenet_window_of_32_launches_qaddsub(dev):
    """A window of 32 (the goldens' 8 requests four times) equal to the
    goldens, its ten ADDs ten qaddsub launches and none on the chain."""
    from band_tpu_torch.tracing import counters

    ex, key, xs, want = _mobilenet(dev)
    order = [i % len(xs) for i in range(32)]
    window = [[xs[i]] for i in order]
    ex.execute_batched(key, window)  # builds the kernels
    torch.cuda.synchronize()
    K.reset_launches()
    before, w0 = counters.snapshot(), sum(ex.windows.values())
    outs = ex.execute_batched(key, window)
    torch.cuda.synchronize()
    windows = sum(ex.windows.values()) - w0
    for i, o in zip(order, outs):
        np.testing.assert_array_equal(o[0].cpu().numpy(), want[i])
    assert windows == 1
    assert K.launch_counts()["qaddsub"] == 10 * windows
    assert counters.delta(counters.snapshot(), before)["addsub_plain"] == 0


def test_codispatch_replay_tallies_qaddsub(dev):
    """A combined program's capture records the ten qaddsub calls of a
    MobileNetV2 window, and each replay counts them; the outputs equal
    the goldens."""
    from band_tpu_torch.backend.executor import build_combo, run_combo

    ex, key, xs, want = _mobilenet(dev)
    window = [[x] for x in xs]
    ex.execute_batched(key, window)  # eager at the bucket first
    torch.cuda.synchronize()
    combo = build_combo([(key, len(xs))], [ex])
    assert combo.launch_tally["qaddsub"] == 10
    K.reset_launches()
    for _ in range(3):
        (outs,) = run_combo(combo, [window])
    torch.cuda.synchronize()
    assert K.launch_counts()["qaddsub"] == 30
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o[0].cpu().numpy(), want[i])
