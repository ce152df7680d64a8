"""Int8 matmul + fused requant: the exact TFLite requant (kernel B1) and
the float32 requant of fast numerics (kernel B4), each with its plain
version.

B1 replaces ``band_tpu/ops/pallas/qmatmul.py:135 qmatmul_exact`` (Pallas
kernel ``_qmatmul_exact_kernel``): every exact int8 FULLY_CONNECTED and
1x1 stride-1 CONV_2D.  B4 replaces ``band_tpu/ops/pallas/qmatmul.py:42
qmatmul`` (Pallas kernel ``_qmatmul_kernel``): every fast one.  The CUDA
source of both is ``csrc/qmatmul.cu``: a tensor-core (``mma.sync`` s8) GEMM
with a ``cp.async`` pipeline, K split over a thread-block cluster where the
output tiles alone leave the card idle, and the requant fused into its
epilogue.  ``gemm_plan`` chooses the tile and the split per shape.  At the
shapes MobileNetV2 gives it, latency bounds it, not the card's memory or
int8 tensor-core rate; see PERF.md for its times beside its bound.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import quant as Q
from . import build
from .common import (LaunchCount, check_epilogue, check_fast_epilogue,
                     check_tensor, on_card, require)

launches = LaunchCount("qmatmul_exact")
fast_launches = LaunchCount("qmatmul_fast")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_fn = None
_fast_fn = None

KSTEP = 32        # K bytes of one tensor-core step (mma m16n8k32)
MAX_SPLITS = 8    # blocks of one thread-block cluster (the portable limit)

# The kernel's block tiles, in the order of the switch in csrc/qmatmul.cu:
# (warps, mi, stage_k) is a block of `warps` warps stacked along M, each
# computing (16 * mi) rows x 32 columns, whose cp.async stages hold
# stage_k bytes of K.  128 x 32, 32 x 32 and 16 x 32 were the fastest of
# eight tiles (16-128 rows, 32-128 columns) on MobileNetV2's GEMMs
# (PERF.md, sweep_gemm.py).
TILES = ((4, 2, 64), (2, 1, 128), (1, 1, 128))
BN = 32           # output columns of every block
# The plan's thresholds, the best of a grid searched with sweep_gemm.py on
# MobileNetV2's GEMMs at b1 and b8 (PERF.md).
TALL_M = 4096     # from this M on, 128-row blocks
SHORT_M = 16      # up to this M, 16-row blocks
SPLIT_BLOCKS = 33  # K is split only below this many blocks (1/4 of the SMs)
SPLIT_KSTEPS = 6  # ... and from this many KSTEP steps of K on
KSTEPS_PER_SPLIT = 2


class GemmPlan(NamedTuple):
    tile: int     # index into TILES
    bm: int       # output rows of a block
    bn: int       # output columns of a block
    splits: int   # blocks along K, one cluster (1: no split)
    kt_per: int   # KSTEP steps of K per split (the last split may be short)
    grid: tuple   # (row blocks, column blocks, splits)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def gemm_plan(M: int, N: int, K: int) -> GemmPlan:
    """The block tile and K split of an M x N x K int8 GEMM.

    Blocks are 32 columns wide and 128 rows tall for M >= TALL_M, 16 for
    M <= SHORT_M, else 32.  If that gives fewer than SPLIT_BLOCKS blocks
    and K has at least SPLIT_KSTEPS steps of KSTEP bytes, K is split into
    slices of about KSTEPS_PER_SPLIT steps, at most MAX_SPLITS of them:
    whole steps, only the last slice short, none empty."""
    tile = 0 if M >= TALL_M else (2 if M <= SHORT_M else 1)
    warps, mi, _ = TILES[tile]
    bm = 16 * mi * warps
    blocks = _cdiv(M, bm) * _cdiv(N, BN)
    ksteps = _cdiv(K, KSTEP)
    splits = 1
    if blocks < SPLIT_BLOCKS and ksteps >= SPLIT_KSTEPS:
        splits = min(MAX_SPLITS, _cdiv(ksteps, KSTEPS_PER_SPLIT))
    kt_per = _cdiv(ksteps, splits)
    if kt_per:
        splits = _cdiv(ksteps, kt_per)
    return GemmPlan(tile, bm, BN, splits, kt_per,
                    (_cdiv(M, bm), _cdiv(N, BN), splits))


def _acc_plain(a, b, bias, w_zp):
    """A . B - w_zp * rowsum(A) + bias as int64 holding the int32 wrap:
    the product in float64 (exact: every partial sum is an integer far
    below 2^53).  Runs on any device."""
    af = a.to(torch.float64)
    acc = af @ b.to(torch.float64)
    if w_zp != 0:
        acc = acc - float(w_zp) * af.sum(dim=1, keepdim=True)
    # the kernel's int32 accumulator wraps; so does this one
    return Q.wrap32(acc.to(torch.int64) + bias.to(torch.int64))


def qmatmul_plain(a, b, bias, qm, shift, out_zp=0, qmin=-128, qmax=127,
                  rounding="ruy", w_zp=0, out_dtype=torch.int8):
    """requant(A . B - w_zp * rowsum(A) + bias) in plain PyTorch, the
    requant in int64."""
    return Q.requantize_exact(_acc_plain(a, b, bias, w_zp),
                              qm.to(torch.int64), shift.to(torch.int64),
                              out_zp, qmin, qmax, out_dtype, rounding)


def qmatmul_fast_plain(a, b, bias, mult, out_zp=0, qmin=-128, qmax=127,
                       w_zp=0, out_dtype=torch.int8):
    """clamp(round_half_even(float32(A . B - w_zp * rowsum(A) + bias) *
    mult) + out_zp) in plain PyTorch (quant.requantize_fast)."""
    return Q.requantize_fast(_acc_plain(a, b, bias, w_zp), mult, out_zp,
                             qmin, qmax, out_dtype)


def _check_operands(a, b):
    dev = a.device
    check_tensor(a, "a", torch.int8, 2, dev)
    check_tensor(b, "b", torch.int8, 2, dev)
    M, K = a.shape
    require(b.shape[0] == K, f"a {tuple(a.shape)} and b {tuple(b.shape)}")
    return M, K, b.shape[1]


def qmatmul_exact(a, b, bias, qm, shift, out_zp=0, qmin=-128, qmax=127,
                  rounding="ruy", w_zp=0, out_dtype=torch.int8):
    """out[M, N] = requant(A[M, K] . B[K, N] - w_zp * rowsum(A) + bias).

    a, b int8; bias int32 [N]; qm, shift int32 [N] or [1].  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global _fn
    out_dtype = Q.torch_dtype(out_dtype)
    M, K, N = _check_operands(a, b)
    qstride = check_epilogue(bias, qm, shift, N, a.device, rounding,
                             out_dtype)
    if not on_card(a):
        return qmatmul_plain(a, b, bias, qm, shift, out_zp, qmin, qmax,
                             rounding, w_zp, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if _fn is None:
        _fn = build.bind("qmatmul", "band_qmatmul_exact", _ARGTYPES)
    plan = gemm_plan(M, N, K)
    build.launch(_fn, a.device, build.ptr(a), build.ptr(b), build.ptr(bias),
                 build.ptr(qm), build.ptr(shift), build.ptr(out), M, N, K,
                 qstride, int(w_zp), int(out_zp), int(qmin), int(qmax),
                 Q.ROUNDING_CODES[rounding], plan.tile, plan.splits,
                 plan.kt_per)
    launches.add()
    return out


def qmatmul_fast(a, b, bias, mult, out_zp=0, qmin=-128, qmax=127, w_zp=0,
                 out_dtype=torch.int8):
    """out[M, N] = clamp(round_half_even(float32(A[M, K] . B[K, N] - w_zp *
    rowsum(A) + bias) * mult) + out_zp, qmin, qmax).

    a, b int8; bias int32 [N]; mult float32 [N] or [1].  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    global _fast_fn
    out_dtype = Q.torch_dtype(out_dtype)
    M, K, N = _check_operands(a, b)
    mstride = check_fast_epilogue(bias, mult, N, a.device, out_dtype)
    if not on_card(a):
        return qmatmul_fast_plain(a, b, bias, mult, out_zp, qmin, qmax, w_zp,
                                  out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if _fast_fn is None:
        _fast_fn = build.bind("qmatmul", "band_qmatmul_fast", _FAST_ARGTYPES)
    plan = gemm_plan(M, N, K)
    build.launch(_fast_fn, a.device, build.ptr(a), build.ptr(b),
                 build.ptr(bias), build.ptr(mult), build.ptr(out), M, N, K,
                 mstride, int(w_zp), int(out_zp), int(qmin), int(qmax),
                 plan.tile, plan.splits, plan.kt_per)
    fast_launches.add()
    return out
