"""Int8 NHWC convolution + fused requant: the exact TFLite requant
(kernel B2) and its fast-numerics instance (float32 requant), each with
its plain version.

Replaces ``band_tpu/ops/pallas/qconv.py:152 qconv2d_exact`` (Pallas
kernel ``_qconv_kernel``).  That kernel took a zero-point-padded input
at stride 1; this one adds stride, dilation and padding (taps outside
the image read ``x_zp``), because on the card it carries every CONV_2D
that is not a 1x1 stride-1 matmul: PyTorch has no int8 convolution on
CUDA, and cuDNN runs float32 convolutions in TF32 by default.  The CUDA
source is ``csrc/qconv.cu``.  ``conv_plan`` picks, from the shape, its
direct kernel (a block stages its input patch and the weights in shared
memory as ``__dp4a`` words, channels padded to 4, 8 or 16 with zero
bytes; for the stems and other convs of Ci up to 16, Oc a multiple of 8
up to 64) or the implicit GEMM over the taps (dy, dx, ci) of
``csrc/qgemm.cuh`` for everything else.  At the slice models' sizes
latency bounds it, not the bytes or the multiplies; see PERF.md.

``qconv2d_fast`` is the same kernel with the float32 epilogue of fast
numerics, which on the TPU was XLA's conv followed by
``requantize_fast`` (band_tpu/ops/lowerings.py:563-575).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import quant as Q
from . import build
from .common import (LaunchCount, alignment, check_epilogue,
                     check_fast_epilogue, check_tensor, on_card, pair,
                     require)

launches = LaunchCount("qconv2d_exact")
fast_launches = LaunchCount("qconv2d_fast")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 32 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 31 + [ctypes.c_void_p]
_fn = None
_fast_fn = None

# The direct kernel's variants (channels, output pixels of a thread), in
# the order of the switch in csrc/qconv.cu.
DIRECT_VARIANTS = ((8, 1), (8, 2))
MAX_DIRECT_CI = 16      # input channels the direct kernel takes, at most
MAX_THREADS = 256       # the direct kernel's launch bound
MAX_OC = 64             # output channels of a direct block, at most
MAX_SMEM = 48 * 1024    # dynamic shared memory without opting in
MAX_GRID_YZ = 65535
GEMM_TILE, GEMM_THREADS = 64, 256   # qgemm.cuh's block tile and threads
# The plan's rule, from sweep_conv.py on the slice models' convs (PERF.md)
PLAN_CV = 8             # channels of a thread
PLAN_THREADS = 128      # threads of a block
PAIR_BLOCKS = 528       # a thread takes 2 pixels where that still leaves
                        # this many blocks (4 per SM), else 1


class ConvPlan(NamedTuple):
    variant: int   # index into DIRECT_VARIANTS; -1: the general loop
    tile: tuple    # (th, tw) output rows and columns of a block
    patch: tuple   # (ph, pw) input rows and columns a block stages
    grid: tuple    # (x, y, z) blocks
    threads: int   # threads of a block
    smem: int      # dynamic shared memory bytes

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def name(self) -> str:
        """direct / channels / pixels / tile, or "general"."""
        if self.variant < 0:
            return "general"
        cv, p = DIRECT_VARIANTS[self.variant]
        return f"direct/c{cv}/p{p}/{self.tile[0]}x{self.tile[1]}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_out_size(size: int, k: int, stride: int, dil: int, pad_total: int):
    return (size + pad_total - (k - 1) * dil - 1) // stride + 1


def general_plan(n: int, oh: int, ow: int, oc: int) -> ConvPlan:
    """qgemm.cuh's implicit GEMM: 64 x 64 tiles of [n*oh*ow, oc], row
    tiles on grid x, 256 threads (the kernel sizes its own grid; this one
    is for the record)."""
    return ConvPlan(-1, (0, 0), (0, 0),
                    (_cdiv(n * oh * ow, GEMM_TILE), _cdiv(oc, GEMM_TILE), 1),
                    GEMM_THREADS, 0)


def direct_words(ci: int) -> int:
    """32-bit words per pixel and tap in the direct kernel: ci padded with
    zero bytes to 4, 8 or 16 channels (its template parameter WP)."""
    return 1 if ci <= 4 else 2 if ci <= 8 else 4


def direct_plan(variant: int, n: int, oh: int, ow: int, ci: int, oc: int,
                kh: int, kw: int, stride, dilation, th: int,
                tw: int) -> ConvPlan:
    """Direct variant ``variant`` on th x tw output tiles: grid (column
    tiles, row tiles, n), one thread per (P pixels, CV channels), the
    patch and the weights in 32-bit words (direct_words(ci) per pixel and
    tap) of shared memory."""
    cv, p = DIRECT_VARIANTS[variant]
    (sh, sw), (dh, dw) = stride, dilation
    ph = (th - 1) * sh + (kh - 1) * dh + 1
    pw = (tw - 1) * sw + (kw - 1) * dw + 1
    smem = 4 * direct_words(ci) * (kh * kw * oc + ph * pw)
    return ConvPlan(variant, (th, tw), (ph, pw),
                    (_cdiv(ow, tw), _cdiv(oh, th), n),
                    th * tw // p * (oc // cv), smem)


def fits(plan: ConvPlan, ci: int, oc: int) -> bool:
    """Whether a direct plan launches: ci within MAX_DIRECT_CI, CV
    divides oc, P the tile, the block and its shared memory within
    bounds."""
    cv, p = DIRECT_VARIANTS[plan.variant]
    th, tw = plan.tile
    return (ci <= MAX_DIRECT_CI and oc % cv == 0 and oc <= MAX_OC
            and (th * tw) % p == 0
            and 0 < plan.threads <= MAX_THREADS and plan.smem <= MAX_SMEM
            and plan.grid[1] <= MAX_GRID_YZ and plan.grid[2] <= MAX_GRID_YZ)


def _tile(pixels: int, ow: int):
    """th x tw = pixels (a power of two), tw up to 16 and no wider than
    the output row needs."""
    tw = min(pixels, 16)
    while tw > 1 and tw // 2 >= ow:
        tw //= 2
    return pixels // tw, tw


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, oh: int, ow: int, ci: int, oc: int, kh: int, kw: int,
              stride, dilation, align: int) -> ConvPlan:
    """The branch, variant and tile of a conv with output [n, oh, ow,
    oc], kh x kw taps over ci input channels, ``stride`` and
    ``dilation`` (sh, sw) pairs, and weights whose base is aligned to
    ``align`` bytes.

    The direct kernel takes ci up to MAX_DIRECT_CI, Oc a multiple of
    PLAN_CV up to MAX_OC and weights on an 8-byte boundary (it loads
    them 8 bytes at a time) while its patch and weights fit MAX_SMEM;
    anything else runs the general loop.  A block has PLAN_THREADS
    threads of PLAN_CV channels (fewer only where the patch would not
    fit); a thread computes 2 output pixels where that leaves PAIR_BLOCKS
    blocks, else 1."""
    groups = oc // PLAN_CV
    if oc % PLAN_CV or oc > MAX_OC or ci > MAX_DIRECT_CI or align % 8:
        return general_plan(n, oh, ow, oc)
    stride, dilation = tuple(stride), tuple(dilation)

    def plan(p, threads):
        th, tw = _tile(threads // groups * p, ow)
        v = DIRECT_VARIANTS.index((PLAN_CV, p))
        return direct_plan(v, n, oh, ow, ci, oc, kh, kw, stride, dilation,
                           th, tw)

    threads = PLAN_THREADS
    p = 2 if plan(2, threads).blocks >= PAIR_BLOCKS else 1
    best = plan(p, threads)
    # a patch too large for shared memory: smaller tiles, then the loop
    while not fits(best, ci, oc) and threads // 2 >= groups:
        threads //= 2
        best = plan(p, threads)
    return best if fits(best, ci, oc) else general_plan(n, oh, ow, oc)


def _acc_plain(x, w_km, bias, kh, kw, stride, dilation, padding, x_zp,
               w_zp):
    """conv(x_pad, w) - w_zp * window-sum(x_pad) + bias as int64 holding
    the int32 wrap: a float64 convolution of the x_zp-padded input
    (exact: integer sums far below 2^53), the window sum by an all-ones
    float64 convolution.  Runs on any device."""
    (pt, pb), (pl, pr) = padding
    n, h, w, ci = x.shape
    oc = w_km.shape[1]
    xp = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), (pl, pr, pt, pb),
               value=float(x_zp))
    wt = w_km.to(torch.float64).reshape(kh, kw, ci, oc).permute(3, 2, 0, 1)
    acc = F.conv2d(xp, wt, stride=tuple(stride), dilation=tuple(dilation))
    if w_zp != 0:
        ones = torch.ones((1, ci, kh, kw), dtype=torch.float64,
                          device=x.device)
        wsum = F.conv2d(xp, ones, stride=tuple(stride),
                        dilation=tuple(dilation))
        acc = acc - float(w_zp) * wsum
    # the kernel's int32 accumulator wraps; so does this one
    return Q.wrap32(acc.permute(0, 2, 3, 1).to(torch.int64)
                    + bias.to(torch.int64))


def qconv2d_plain(x, w_km, bias, qm, shift, kh, kw, stride=(1, 1),
                  dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0, w_zp=0,
                  out_zp=0, qmin=-128, qmax=127, rounding="ruy",
                  out_dtype=torch.int8):
    """qconv2d_exact in plain PyTorch, the requant in int64."""
    acc = _acc_plain(x, w_km, bias, kh, kw, stride, dilation, padding, x_zp,
                     w_zp)
    return Q.requantize_exact(acc, qm.to(torch.int64), shift.to(torch.int64),
                              out_zp, qmin, qmax, out_dtype, rounding)


def qconv2d_fast_plain(x, w_km, bias, mult, kh, kw, stride=(1, 1),
                       dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0,
                       w_zp=0, out_zp=0, qmin=-128, qmax=127,
                       out_dtype=torch.int8):
    """qconv2d_fast in plain PyTorch (quant.requantize_fast)."""
    acc = _acc_plain(x, w_km, bias, kh, kw, stride, dilation, padding, x_zp,
                     w_zp)
    return Q.requantize_fast(acc, mult, out_zp, qmin, qmax, out_dtype)


def _geometry(x, w_km, kh, kw, stride, dilation, padding):
    """Checks x and w_km; returns (n, h, w, ci, oc, oh, ow, (sh, sw),
    (dh, dw), ((pt, pb), (pl, pr)))."""
    dev = x.device
    check_tensor(x, "x", torch.int8, 4, dev)
    check_tensor(w_km, "w_km", torch.int8, 2, dev)
    n, h, w, ci = x.shape
    require(w_km.shape[0] == kh * kw * ci,
            f"w_km {tuple(w_km.shape)} != [{kh}*{kw}*{ci}, Oc]")
    sh, sw = pair(stride)
    dh, dw = pair(dilation)
    (pt, pb), (pl, pr) = padding
    require(min(sh, sw, dh, dw) >= 1 and min(pt, pb, pl, pr) >= 0,
            "strides and dilations >= 1, pads >= 0")
    oh = conv_out_size(h, kh, sh, dh, pt + pb)
    ow = conv_out_size(w, kw, sw, dw, pl + pr)
    require(oh >= 1 and ow >= 1, "empty convolution output")
    return (n, h, w, ci, w_km.shape[1], oh, ow, (sh, sw), (dh, dw),
            ((pt, pb), (pl, pr)))


def _plan_args(p: ConvPlan):
    """A plan as the C entry points take it: variant, th, tw, ph, pw,
    grid x, y, z, threads, shared memory bytes."""
    return (p.variant, *p.tile, *p.patch, *p.grid, p.threads, p.smem)


def qconv2d_exact(x, w_km, bias, qm, shift, kh, kw, stride=(1, 1),
                  dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0, w_zp=0,
                  out_zp=0, qmin=-128, qmax=127, rounding="ruy",
                  out_dtype=torch.int8):
    """out[N, OH, OW, Oc] = requant(conv(x_pad, w) - w_zp * window-sum
    (x_pad) + bias), x_pad = x padded with x_zp by ``padding`` =
    ((top, bottom), (left, right)).

    x int8 [N, H, W, Ci]; w_km int8 [kh*kw*Ci, Oc] (taps dy, dx, ci);
    bias int32 [Oc]; qm, shift int32 [Oc] or [1].  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    global _fn
    out_dtype = Q.torch_dtype(out_dtype)
    n, h, w, ci, oc, oh, ow, (sh, sw), (dh, dw), pads = _geometry(
        x, w_km, kh, kw, stride, dilation, padding)
    (pt, pb), (pl, pr) = pads
    qstride = check_epilogue(bias, qm, shift, oc, x.device, rounding,
                             out_dtype)
    if not on_card(x):
        return qconv2d_plain(x, w_km, bias, qm, shift, kh, kw, (sh, sw),
                             (dh, dw), pads, x_zp, w_zp, out_zp, qmin, qmax,
                             rounding, out_dtype)
    require(n * oh * ow < 2**31 and x.numel() < 2**31,
            "tensor too large for 32-bit indexing")
    out = torch.empty((n, oh, ow, oc), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    if _fn is None:
        _fn = build.bind("qconv", "band_qconv2d_exact", _ARGTYPES)
    p = conv_plan(n, oh, ow, ci, oc, kh, kw, (sh, sw), (dh, dw),
                  alignment(w_km))
    build.launch(_fn, x.device, build.ptr(x), build.ptr(w_km),
                 build.ptr(bias), build.ptr(qm), build.ptr(shift),
                 build.ptr(out), n, h, w, ci, oh, ow, oc, kh, kw, sh, sw, dh,
                 dw, pt, pl, qstride, int(x_zp), int(w_zp), int(out_zp),
                 int(qmin), int(qmax), Q.ROUNDING_CODES[rounding],
                 *_plan_args(p))
    launches.add()
    return out


def qconv2d_fast(x, w_km, bias, mult, kh, kw, stride=(1, 1),
                 dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0, w_zp=0,
                 out_zp=0, qmin=-128, qmax=127, out_dtype=torch.int8):
    """The fast-numerics instance of qconv2d_exact: out = clamp(
    round_half_even(float32(conv(x_pad, w) - w_zp * window-sum(x_pad) +
    bias) * mult) + out_zp, qmin, qmax), mult float32 [Oc] or [1].  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global _fast_fn
    out_dtype = Q.torch_dtype(out_dtype)
    n, h, w, ci, oc, oh, ow, (sh, sw), (dh, dw), pads = _geometry(
        x, w_km, kh, kw, stride, dilation, padding)
    (pt, pb), (pl, pr) = pads
    mstride = check_fast_epilogue(bias, mult, oc, x.device, out_dtype)
    if not on_card(x):
        return qconv2d_fast_plain(x, w_km, bias, mult, kh, kw, (sh, sw),
                                  (dh, dw), pads, x_zp, w_zp, out_zp, qmin,
                                  qmax, out_dtype)
    require(n * oh * ow < 2**31 and x.numel() < 2**31,
            "tensor too large for 32-bit indexing")
    out = torch.empty((n, oh, ow, oc), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    if _fast_fn is None:
        _fast_fn = build.bind("qconv", "band_qconv2d_fast", _FAST_ARGTYPES)
    p = conv_plan(n, oh, ow, ci, oc, kh, kw, (sh, sw), (dh, dw),
                  alignment(w_km))
    build.launch(_fast_fn, x.device, build.ptr(x), build.ptr(w_km),
                 build.ptr(bias), build.ptr(mult), build.ptr(out), n, h, w,
                 ci, oh, ow, oc, kh, kw, sh, sw, dh, dw, pt, pl, mstride,
                 int(x_zp), int(w_zp), int(out_zp), int(qmin), int(qmax),
                 *_plan_args(p))
    fast_launches.add()
    return out
