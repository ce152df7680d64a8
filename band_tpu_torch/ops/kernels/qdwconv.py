"""Int8 depthwise convolution + fused requant: the exact TFLite requant
(kernel B3) and its fast-numerics instance (float32 requant), each with
its plain version.

Replaces ``band_tpu/ops/pallas/qdwconv.py:114 qdwconv2d_exact`` (Pallas
kernel ``_qdwconv_kernel``).  On the TPU it ran only for narrow
boundary inputs; on the card it carries every int8 DEPTHWISE_CONV_2D,
with strides, dilation, depth multiplier > 1 and padding (taps outside
the image read ``x_zp``).  The CUDA source is ``csrc/qdwconv.cu``: a
thread owns a vector of channels and a strip of output columns, loads
its input window once and sums each vertical tap column with one
``__dp4a``.  ``dwconv_plan`` picks the strip and the block per shape;
geometries the strip kernel does not take (a ragged C or a misaligned
base among them) run a general one-thread-per-output loop.  At
MobileNetV2's shapes latency bounds it, not the card's memory or ALUs;
see PERF.md.

``qdwconv2d_fast`` is the same kernel with the float32 epilogue of fast
numerics, which on the TPU was XLA's grouped conv followed by
``requantize_fast`` (band_tpu/ops/lowerings.py:943-964).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import quant as Q
from . import build
from .common import (LaunchCount, alignment,  # noqa: F401
                     check_epilogue, check_fast_epilogue, check_tensor,
                     on_card, pair, require)
from .qconv import conv_out_size

launches = LaunchCount("qdwconv2d_exact")
fast_launches = LaunchCount("qdwconv2d_fast")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 28 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 27 + [ctypes.c_void_p]
_fn = None
_fast_fn = None

# The strip kernel's variants (kh = kw, horizontal stride, output columns
# per thread), in the order of the switch in csrc/qdwconv.cu.
VARIANTS = tuple([(3, sw, r) for sw in (1, 2) for r in (1, 2, 4)]
                 + [(5, sw, 2) for sw in (1, 2)])
VEC = 4                 # channels per strip thread: one 32-bit load per
                        # pixel, so C and the bases must be multiples of 4
MAX_THREADS = 256       # the kernels' launch bound
GENERAL_THREADS = 256   # block of the general loop
MAX_GRID_Z = 65535      # n * oh rides on grid z, strips on grid y
# The plan's thresholds, from sweep_dwconv.py on MobileNetV2's depthwise
# convs at b1 and b8 (PERF.md).
STRIP_2 = 100_000       # outputs (n * oh * ow * c) from which a thread
STRIP_4 = 400_000       # computes 2, and 4, neighbouring columns
BLOCK_STRIPS = 32       # strips of one block, at most
MIN_BLOCKS = 66         # blocks shrink (down to 32 threads) to fill half
                        # of the card's 132 SMs


class DwPlan(NamedTuple):
    variant: int   # index into VARIANTS; -1: the general loop
    r: int         # output columns per thread
    block: tuple   # (threads along channel groups, along column strips)
    grid: tuple    # (channel-group blocks, strip blocks, n * oh)

    @property
    def vec(self) -> int:
        """Channels per thread."""
        return VEC if self.variant >= 0 else 1

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def name(self) -> str:
        """kh x kw / horizontal stride / vec / r / block, or "general"."""
        if self.variant < 0:
            return "general"
        kh, sw, r = VARIANTS[self.variant]
        return f"{kh}x{kh}/s{sw}/v{VEC}/r{r}/{self.block[0]}x{self.block[1]}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def general_plan(n: int, oh: int, ow: int, co: int) -> DwPlan:
    """One thread per output byte, GENERAL_THREADS to a block."""
    return DwPlan(-1, 1, (GENERAL_THREADS, 1),
                  (_cdiv(n * oh * ow * co, GENERAL_THREADS), 1, 1))


def strip_plan(variant: int, n: int, oh: int, ow: int, c: int,
               threads: int = MAX_THREADS,
               block_strips: int = BLOCK_STRIPS) -> DwPlan:
    """The grid and block of strip variant ``variant``: channel groups
    fastest (neighbouring threads load neighbouring bytes), up to
    ``threads`` of them, then up to ``block_strips`` column strips within
    ``threads``; the grid adds n * oh on z."""
    r = VARIANTS[variant][2]
    groups, strips = c // VEC, _cdiv(ow, r)
    bx = min(groups, threads)
    by = max(1, min(strips, block_strips, threads // bx))
    return DwPlan(variant, r, (bx, by),
                  (_cdiv(groups, bx), _cdiv(strips, by), n * oh))


@functools.lru_cache(maxsize=None)
def dwconv_plan(n: int, oh: int, ow: int, c: int, mult: int, kh: int,
                kw: int, stride, dilation, align: int) -> DwPlan:
    """Variant, block and grid of a depthwise conv with output [n, oh,
    ow, c * mult], kh x kw taps, ``stride`` and ``dilation`` (sh, sw)
    pairs, and base addresses (x, w, out) aligned to ``align`` bytes.

    The strip kernel takes VEC channels per thread where VEC divides c and
    ``align``, multiplier 1, dilation 1, 3x3 and 5x5 taps and a
    horizontal stride of 1 or 2; anything else, or more than MAX_GRID_Z
    rows or columns of output, runs the general loop.  A strip thread
    computes 4 columns from STRIP_4 outputs on, 2 from STRIP_2, else 1
    (of the strips the variant table has, the nearest).  Blocks are as
    in strip_plan, of 256 threads, or halved down to 32 while that gives
    fewer than MIN_BLOCKS blocks."""
    sh, sw = stride
    if (c % VEC or align % VEC or mult != 1 or tuple(dilation) != (1, 1)
            or kh != kw or n * oh > MAX_GRID_Z or ow > MAX_GRID_Z):
        return general_plan(n, oh, ow, c * mult)
    strips = {r: i for i, (k, s, r) in enumerate(VARIANTS)
              if (k, s) == (kh, sw)}
    if not strips:
        return general_plan(n, oh, ow, c * mult)
    outputs = n * oh * ow * c
    want = 4 if outputs >= STRIP_4 else (2 if outputs >= STRIP_2 else 1)
    r = min(strips, key=lambda r: (abs(r - want), -r))
    threads = MAX_THREADS
    plan = strip_plan(strips[r], n, oh, ow, c, threads)
    while plan.blocks < MIN_BLOCKS and threads > 32:
        threads //= 2
        plan = strip_plan(strips[r], n, oh, ow, c, threads)
    return plan


def _acc_plain(x, w, bias, kh, kw, stride, dilation, padding, x_zp, w_zp):
    """The depthwise sum over taps - w_zp * window-sum + bias as int64
    holding the int32 wrap: a grouped float64 convolution of the
    x_zp-padded input (exact), per-channel window sums by a grouped
    all-ones convolution.  Runs on any device."""
    (pt, pb), (pl, pr) = padding
    ci = x.shape[-1]
    co = w.shape[1]
    mult = co // ci
    xp = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb),
               value=float(x_zp))
    wt = w.to(torch.float64).reshape(kh, kw, co).permute(2, 0, 1)
    acc = F.conv2d(xp, wt.unsqueeze(1), stride=tuple(stride),
                   dilation=tuple(dilation), groups=ci)
    if w_zp != 0:
        ones = torch.ones((ci, 1, kh, kw), dtype=torch.float64,
                          device=x.device)
        wsum = F.conv2d(xp, ones, stride=tuple(stride),
                        dilation=tuple(dilation), groups=ci)
        acc = acc - float(w_zp) * wsum.repeat_interleave(mult, dim=1)
    # the kernel's int32 accumulator wraps; so does this one
    return Q.wrap32(acc.permute(0, 2, 3, 1).to(torch.int64)
                    + bias.to(torch.int64))


def qdwconv2d_plain(x, w, bias, qm, shift, kh, kw, stride=(1, 1),
                    dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0,
                    w_zp=0, out_zp=0, qmin=-128, qmax=127, rounding="ruy",
                    out_dtype=torch.int8):
    """qdwconv2d_exact in plain PyTorch, the requant in int64."""
    acc = _acc_plain(x, w, bias, kh, kw, stride, dilation, padding, x_zp,
                     w_zp)
    return Q.requantize_exact(acc, qm.to(torch.int64), shift.to(torch.int64),
                              out_zp, qmin, qmax, out_dtype, rounding)


def qdwconv2d_fast_plain(x, w, bias, mult, kh, kw, stride=(1, 1),
                         dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0,
                         w_zp=0, out_zp=0, qmin=-128, qmax=127,
                         out_dtype=torch.int8):
    """qdwconv2d_fast in plain PyTorch (quant.requantize_fast)."""
    acc = _acc_plain(x, w, bias, kh, kw, stride, dilation, padding, x_zp,
                     w_zp)
    return Q.requantize_fast(acc, mult, out_zp, qmin, qmax, out_dtype)


def _geometry(x, w, kh, kw, stride, dilation, padding):
    """Checks x and w; returns (n, h, wd, ci, mult, co, oh, ow, (sh, sw),
    (dh, dw), ((pt, pb), (pl, pr)))."""
    dev = x.device
    check_tensor(x, "x", torch.int8, 4, dev)
    check_tensor(w, "w", torch.int8, 2, dev)
    n, h, wd, ci = x.shape
    co = w.shape[1]
    require(w.shape[0] == kh * kw and co % ci == 0,
            f"w {tuple(w.shape)} != [{kh}*{kw}, {ci}*mult]")
    sh, sw = pair(stride)
    dh, dw = pair(dilation)
    (pt, pb), (pl, pr) = padding
    require(min(sh, sw, dh, dw) >= 1 and min(pt, pb, pl, pr) >= 0,
            "strides and dilations >= 1, pads >= 0")
    oh = conv_out_size(h, kh, sh, dh, pt + pb)
    ow = conv_out_size(wd, kw, sw, dw, pl + pr)
    require(oh >= 1 and ow >= 1, "empty convolution output")
    return (n, h, wd, ci, co // ci, co, oh, ow, (sh, sw), (dh, dw),
            ((pt, pb), (pl, pr)))


def qdwconv2d_exact(x, w, bias, qm, shift, kh, kw, stride=(1, 1),
                    dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0,
                    w_zp=0, out_zp=0, qmin=-128, qmax=127, rounding="ruy",
                    out_dtype=torch.int8):
    """out[N, OH, OW, C*mult] = requant(sum over taps of x_pad[.., c // mult]
    * w[tap, c] - w_zp * window-sum + bias), x_pad = x padded with x_zp.

    x int8 [N, H, W, C]; w int8 [kh*kw, C*mult]; bias int32 [C*mult];
    qm, shift int32 [C*mult] or [1].  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    global _fn
    out_dtype = Q.torch_dtype(out_dtype)
    n, h, wd, ci, mult, co, oh, ow, (sh, sw), (dh, dw), pads = _geometry(
        x, w, kh, kw, stride, dilation, padding)
    (pt, pb), (pl, pr) = pads
    qstride = check_epilogue(bias, qm, shift, co, x.device, rounding,
                             out_dtype)
    if not on_card(x):
        return qdwconv2d_plain(x, w, bias, qm, shift, kh, kw, (sh, sw),
                               (dh, dw), pads, x_zp, w_zp, out_zp, qmin,
                               qmax, rounding, out_dtype)
    require(n * oh * ow * co < 2**31 and x.numel() < 2**31,
            "tensor too large for 32-bit indexing")
    out = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    if _fn is None:
        _fn = build.bind("qdwconv", "band_qdwconv2d_exact", _ARGTYPES)
    p = dwconv_plan(n, oh, ow, ci, mult, kh, kw, (sh, sw), (dh, dw),
                    alignment(x, w, out))
    build.launch(_fn, x.device, build.ptr(x), build.ptr(w), build.ptr(bias),
                 build.ptr(qm), build.ptr(shift), build.ptr(out), n, h, wd,
                 ci, mult, oh, ow, kh, kw, sh, sw, dh, dw, pt, pl, qstride,
                 int(x_zp), int(w_zp), int(out_zp), int(qmin), int(qmax),
                 Q.ROUNDING_CODES[rounding], p.variant, *p.grid, *p.block)
    launches.add()
    return out


def qdwconv2d_fast(x, w, bias, mult, kh, kw, stride=(1, 1), dilation=(1, 1),
                   padding=((0, 0), (0, 0)), x_zp=0, w_zp=0, out_zp=0,
                   qmin=-128, qmax=127, out_dtype=torch.int8):
    """The fast-numerics instance of qdwconv2d_exact: out = clamp(
    round_half_even(float32(depthwise sum - w_zp * window-sum + bias) *
    mult) + out_zp, qmin, qmax), mult float32 [C*mult] or [1].  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global _fast_fn
    out_dtype = Q.torch_dtype(out_dtype)
    n, h, wd, ci, dm, co, oh, ow, (sh, sw), (dh, dw), pads = _geometry(
        x, w, kh, kw, stride, dilation, padding)
    (pt, pb), (pl, pr) = pads
    mstride = check_fast_epilogue(bias, mult, co, x.device, out_dtype)
    if not on_card(x):
        return qdwconv2d_fast_plain(x, w, bias, mult, kh, kw, (sh, sw),
                                    (dh, dw), pads, x_zp, w_zp, out_zp, qmin,
                                    qmax, out_dtype)
    require(n * oh * ow * co < 2**31 and x.numel() < 2**31,
            "tensor too large for 32-bit indexing")
    out = torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    if _fast_fn is None:
        _fast_fn = build.bind("qdwconv", "band_qdwconv2d_fast",
                              _FAST_ARGTYPES)
    p = dwconv_plan(n, oh, ow, ci, dm, kh, kw, (sh, sw), (dh, dw),
                    alignment(x, w, out))
    build.launch(_fast_fn, x.device, build.ptr(x), build.ptr(w),
                 build.ptr(bias), build.ptr(mult), build.ptr(out), n, h, wd,
                 ci, dm, oh, ow, kh, kw, sh, sw, dh, dw, pt, pl, mstride,
                 int(x_zp), int(w_zp), int(out_zp), int(qmin), int(qmax),
                 p.variant, *p.grid, *p.block)
    fast_launches.add()
    return out
