"""Int8 NHWC convolution + fused requant: the exact TFLite requant
(kernel B2) and its fast-numerics instance (float32 requant), each with
its plain version.

Replaces ``band_tpu/ops/pallas/qconv.py:152 qconv2d_exact`` (Pallas
kernel ``_qconv_kernel``).  That kernel took a zero-point-padded input
at stride 1; this one adds stride, dilation and padding (taps outside
the image read ``x_zp``), because on the card it carries every CONV_2D
that is not a 1x1 stride-1 matmul, and every TRANSPOSE_CONV: PyTorch has
no int8 convolution on CUDA, and cuDNN runs float32 convolutions in TF32
by default.  The CUDA source is ``csrc/qconv.cu``.  ``conv_plan`` picks,
from the shape, its direct kernel (a block stages its input patch and the
weights in shared memory as ``__dp4a`` words, channels padded to 4, 8 or
16 with zero bytes; for the stems and other convs of Ci up to 16, Oc a
multiple of 8 up to 64) or the general branch: the tensor-core implicit
GEMM of ``csrc/qconv_mma.cuh`` (a block stages its input patch once, K
runs in 16-byte chunks of (tap, channel slab) through ``ldmatrix`` and
``mma.sync`` m16n8k32, an N tile of 8, 16 or 32 columns).  The ``__dp4a``
loop of ``csrc/qgemm.cuh``, the first port's general branch, is picked by
no plan; ``loop_plan`` forces it for comparison.  See PERF.md for what
bounds each.

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
# the launches of each that took the mma branch (csrc/qconv_mma.cuh)
mma_launches = LaunchCount("qconv2d_exact_mma")
fast_mma_launches = LaunchCount("qconv2d_fast_mma")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 35 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 34 + [ctypes.c_void_p]
_fn = None
_fast_fn = None

# The direct kernel's variants (channels, output pixels of a thread), in
# the order of the switch in csrc/qconv.cu.
DIRECT_VARIANTS = ((8, 1), (8, 2))
MAX_DIRECT_CI = 16      # input channels the direct kernel takes, at most
MAX_THREADS = 256       # the direct kernel's launch bound
MAX_OC = 64             # output channels of a direct block, at most
MAX_SMEM = 48 * 1024    # dynamic shared memory without opting in
MAX_SMEM_OPTIN = 232448  # a block's dynamic shared memory with the opt-in
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65535
GEMM_TILE, GEMM_THREADS = 64, 256   # qgemm.cuh's block tile and threads
# The mma branch (csrc/qconv_mma.cuh): N tiles (8 << variant columns),
# block pixels (64 MI, MI = 2 or 4), 4 warps; K chunks of 16 bytes.
MMA_NTILES = (8, 16, 32)
MMA_PIXELS = (128, 256)
MMA_THREADS = 128
CHUNK = 16
# K bytes of a group (its padding included) from which the tensor cores'
# int32 sums could overflow (|a * b| <= 2^14): each group stays below, and
# the kernel adds the groups' sums modulo 2^32.
MAX_MMA_K = 2**17
BRANCHES = ("direct", "mma", "loop")  # the C side's branch codes 0, 1, 2
# The plan's rule, from sweep_conv.py on the slice models' convs (PERF.md)
PLAN_CV = 8             # channels of a thread
PLAN_THREADS = 128      # threads of a block
PAIR_BLOCKS = 528       # a thread takes 2 pixels where that still leaves
                        # this many blocks (4 per SM), else 1
PLAN_MMA_WIDE = 264     # 16 x 16 mma tiles where they leave this many
                        # blocks (2 per SM), else 8 x 16
PLAN_MMA_NARROW = 132   # below this many pixel tiles (one per SM), N
                        # tiles of 8, for more blocks


class ConvPlan(NamedTuple):
    branch: str    # "direct", "mma" or "loop" (BRANCHES)
    variant: int   # direct: index into DIRECT_VARIANTS; mma: N tile index
                   # into MMA_NTILES; loop: -1
    tile: tuple    # (th, tw) output rows and columns of a block
    patch: tuple   # (ph, pw) input rows and columns a block stages
    grid: tuple    # (x, y, z) blocks
    threads: int   # threads of a block
    smem: int      # dynamic shared memory bytes
    slabs: int = 0  # mma: 16-channel slabs of a channel group
    gather: bool = False  # mma: one tap a group, no halo (mma_plan)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def name(self) -> str:
        """direct / channels / pixels / tile; mma / N tile / tile /
        channels of a group [/ gather]; or "loop"."""
        if self.branch == "loop":
            return "loop"
        th, tw = self.tile
        if self.branch == "mma":
            return (f"mma/n{MMA_NTILES[self.variant]}/{th}x{tw}/"
                    f"c{CHUNK * self.slabs}" + "/gather" * self.gather)
        cv, p = DIRECT_VARIANTS[self.variant]
        return f"direct/c{cv}/p{p}/{th}x{tw}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_out_size(size: int, k: int, stride: int, dil: int, pad_total: int):
    return (size + pad_total - (k - 1) * dil - 1) // stride + 1


def loop_plan(n: int, oh: int, ow: int, oc: int) -> ConvPlan:
    """qgemm.cuh's __dp4a implicit-GEMM loop: 64 x 64 tiles of [n*oh*ow,
    oc], row tiles on grid x, 256 threads (the kernel sizes its own grid;
    this one is for the record)."""
    return ConvPlan("loop", -1, (0, 0), (0, 0),
                    (_cdiv(n * oh * ow, GEMM_TILE), _cdiv(oc, GEMM_TILE), 1),
                    GEMM_THREADS, 0)


def mma_layout(ph: int, pw: int, kh: int, kw: int, slabs: int):
    """(pixel bytes, column bytes, K steps, bytes of shared memory without
    the weights) of an mma block: a patch pixel holds ``slabs`` slabs of 16
    channels in an odd number of 16-byte units (ldmatrix's 8 row addresses
    in 8 bank groups); a weight column, the group's kh*kw*slabs chunks
    rounded up to whole m16n8k32 steps plus one unit; the chunk table, an
    int per chunk."""
    ps = CHUNK * (slabs | 1)
    ksteps = (kh * kw * slabs + 1) // 2
    ws = 2 * CHUNK * ksteps + CHUNK
    return ps, ws, ksteps, ph * pw * ps + 8 * ksteps


def mma_plan(variant: int, n: int, oh: int, ow: int, oc: int, kh: int,
             kw: int, stride, dilation, th: int, tw: int, slabs: int,
             gather: bool = False) -> ConvPlan:
    """The mma branch with N tile MMA_NTILES[variant] on th x tw output
    tiles and channel groups of ``slabs`` slabs: grid (pixel tiles of all
    images, column tiles), 128 threads, the patch, weights and chunk
    table in shared memory (csrc/qconv_mma.cuh mma_smem).  A gathering
    block stages, one tap at a time, the input pixel of each output pixel
    for that tap: its patch is th x tw pixels, whatever the stride,
    dilation and taps."""
    (sh, sw), (dh, dw) = stride, dilation
    if gather:
        (ph, pw), taps = (th, tw), (1, 1)
    else:
        ph = (th - 1) * sh + (kh - 1) * dh + 1
        pw = (tw - 1) * sw + (kw - 1) * dw + 1
        taps = (kh, kw)
    bn = MMA_NTILES[variant]
    _, ws, _, rest = mma_layout(ph, pw, *taps, slabs)
    return ConvPlan("mma", variant, (th, tw), (ph, pw),
                    (n * _cdiv(oh, th) * _cdiv(ow, tw), _cdiv(oc, bn), 1),
                    MMA_THREADS, rest + bn * ws, slabs, gather)


def mma_fits(plan: ConvPlan, ci: int, kh: int, kw: int) -> bool:
    """Whether an mma plan of a conv with kh x kw taps launches: 128 or
    256 pixels a block, 1 to ceil(ci / 16) slabs a group, a group's K
    steps below MAX_MMA_K bytes, its shared memory within the opt-in
    limit, its grid within bounds."""
    th, tw = plan.tile
    taps = 1 if plan.gather else kh * kw
    ksteps = _cdiv(taps * plan.slabs, 2)
    return (th * tw in MMA_PIXELS and 1 <= plan.slabs <= _cdiv(ci, CHUNK)
            and 2 * CHUNK * ksteps < MAX_MMA_K
            and plan.smem <= MAX_SMEM_OPTIN
            and plan.grid[0] <= MAX_GRID_X and plan.grid[1] <= MAX_GRID_YZ)


def mma_ntile(oc: int) -> int:
    """The narrowest N tile that holds oc columns, else the widest."""
    return next((i for i, bn in enumerate(MMA_NTILES) if oc <= bn),
                len(MMA_NTILES) - 1)


def mma_tile(pixels: int):
    """th x tw = pixels output pixels, 16 to a row: the squarest tile of
    16-pixel m16 rows, whose halo is smallest."""
    return pixels // 16, 16


def general_plan(n: int, oh: int, ow: int, ci: int, oc: int, kh: int,
                 kw: int, stride, dilation) -> ConvPlan:
    """The general branch of a conv that the direct kernel does not take:
    the mma branch on 16 x 16 tiles where they leave PLAN_MMA_WIDE blocks,
    else 8 x 16; with the narrowest N tile that holds oc, or N tiles of 8
    where the pixel tiles are fewer than PLAN_MMA_NARROW; its channel
    groups as few as keep it within MAX_SMEM (else the fewest within
    MAX_SMEM_OPTIN), each below MAX_MMA_K bytes of K.  Where no group
    fits at that N tile, the narrower N tiles, then the wider; where none
    fits at all (a halo too large for shared memory), the same search for
    a gathering block, which fits with one slab a group.  Only a grid
    beyond its bounds (Oc above 65,535 column tiles of 32) has no plan."""
    wide = n * _cdiv(oh, 16) * _cdiv(ow, 16) >= PLAN_MMA_WIDE
    th, tw = mma_tile(MMA_PIXELS[1] if wide else MMA_PIXELS[0])
    narrow = n * _cdiv(oh, th) * _cdiv(ow, tw) < PLAN_MMA_NARROW
    v0 = 0 if narrow else mma_ntile(oc)
    ntiles = [v0, *range(v0 - 1, -1, -1), *range(v0 + 1, len(MMA_NTILES))]
    nslab = _cdiv(ci, CHUNK)
    for gather in (False, True):
        for v in ntiles:
            for limit in (MAX_SMEM, MAX_SMEM_OPTIN):
                for groups in range(1, nslab + 1):
                    p = mma_plan(v, n, oh, ow, oc, kh, kw, stride, dilation,
                                 th, tw, _cdiv(nslab, groups), gather)
                    if p.smem <= limit and mma_fits(p, ci, kh, kw):
                        return p
    raise ValueError(f"B2: no mma plan fits a conv of {n} x {oh} x {ow} "
                     f"outputs and {oc} channels")


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
    return ConvPlan("direct", variant, (th, tw), (ph, pw),
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
    them 8 bytes at a time) while its patch and weights fit MAX_SMEM; a
    block has PLAN_THREADS threads of PLAN_CV channels (fewer only where
    the patch would not fit); a thread computes 2 output pixels where
    that leaves PAIR_BLOCKS blocks, else 1.  Anything else takes the
    general branch (general_plan), the mma branch, whatever its K, taps,
    stride or dilation.  The plan reaches qgemm.cuh's loop for no shape:
    only the forcing hook does (loop_plan)."""
    stride, dilation = tuple(stride), tuple(dilation)
    if (oc % PLAN_CV or oc > MAX_OC or ci > MAX_DIRECT_CI or align % 8):
        return general_plan(n, oh, ow, ci, oc, kh, kw, stride, dilation)
    groups = oc // PLAN_CV

    def plan(p, threads):
        th, tw = _tile(threads // groups * p, ow)
        v = DIRECT_VARIANTS.index((PLAN_CV, p))
        return direct_plan(v, n, oh, ow, ci, oc, kh, kw, stride, dilation,
                           th, tw)

    threads = PLAN_THREADS
    p = 2 if plan(2, threads).blocks >= PAIR_BLOCKS else 1
    best = plan(p, threads)
    # a patch too large for shared memory: smaller tiles, then the
    # general branch
    while not fits(best, ci, oc) and threads // 2 >= groups:
        threads //= 2
        best = plan(p, threads)
    return (best if fits(best, ci, oc) else
            general_plan(n, oh, ow, ci, oc, kh, kw, stride, dilation))


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
    """A plan as the C entry points take it: branch code, variant, th,
    tw, ph, pw, grid x, y, z, threads, shared memory bytes, slabs,
    gather."""
    return (BRANCHES.index(p.branch), p.variant, *p.tile, *p.patch, *p.grid,
            p.threads, p.smem, p.slabs, int(p.gather))


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
    if p.branch == "mma":
        mma_launches.add()
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
    if p.branch == "mma":
        fast_mma_launches.add()
    return out
