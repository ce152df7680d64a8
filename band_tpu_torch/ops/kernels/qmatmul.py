"""Int8 matmul + fused requant: the exact TFLite requant (kernel B1), the
float32 requant of fast numerics (kernel B4), and B4's core with the
float32-output epilogue of dynamic-range models (``qmatmul_hybrid``),
each with its plain version.

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

``qmatmul_hybrid`` serves every hybrid FULLY_CONNECTED and 1x1 stride-1
CONV_2D of a dynamic-range model: A holds the int8 codes of float rows
quantized at run time (ops/quant.py), and the epilogue rescales the int32
sum to float32 (requant.cuh HybridEpilogue).  In band_tpu that product is
``jnp.dot`` (band_tpu/ops/lowerings.py:239-242, :971-995), not a Pallas
kernel; on the card a float32 product of int8 values stops being exact
once |acc| passes 2^24, and PyTorch's int8 product (``torch._int_mm``)
takes no M below 17, so it runs on this kernel.
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
hybrid_launches = LaunchCount("qmatmul_hybrid")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_HYBRID_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_fn = None
_fast_fn = None
_hybrid_fn = None

# fused activations of the hybrid epilogue, by TFLite name
HYBRID_ACTIVATIONS = {"NONE": 0, "RELU": 1, "RELU6": 2}

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


def hybrid_activation(v: torch.Tensor, activation: str) -> torch.Tensor:
    """The hybrid epilogue's fused activation: v < 0 -> 0 (RELU), and v >
    6 -> 6 (RELU6), as requant.cuh compares (a NaN passes through)."""
    if activation == "NONE":
        return v
    v = torch.where(v < 0.0, 0.0, v)
    return torch.where(v > 6.0, 6.0, v) if activation == "RELU6" else v


def qmatmul_hybrid_plain(a, b, w_scale, w_rowsum, zp, scale, bias=None,
                         rows=1, activation="NONE"):
    """act((float32(A . B) - zp * rowsum) * (scale * w_scale) + bias) in
    plain PyTorch: the product in float64 (exact), then band_tpu's float32
    steps (band_tpu/ops/lowerings.py:985-995), each rounded once.  zp and
    scale hold one entry per ``rows`` rows of A; zp None: symmetric rows
    (no rowsum term); bias None: no bias."""
    acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
    v = Q.wrap32(acc).to(torch.int32).to(torch.float32)
    if zp is not None:
        zp_r = zp.reshape(-1, 1).repeat_interleave(rows, dim=0)
        v = v - zp_r * w_rowsum.to(torch.float32)
    scale_r = scale.reshape(-1, 1).repeat_interleave(rows, dim=0)
    v = v * (scale_r * w_scale)
    if bias is not None:
        v = v + bias
    return hybrid_activation(v, activation)


def _check_hybrid(a, b, w_scale, w_rowsum, zp, scale, bias, rows,
                  activation):
    M, K, N = _check_operands(a, b)
    dev = a.device
    check_tensor(w_scale, "w_scale", torch.float32, 1, dev)
    require(w_scale.numel() == N, f"w_scale has {w_scale.numel()} != {N}")
    require(rows >= 1 and M % rows == 0, f"{M} rows in groups of {rows}")
    check_tensor(scale, "scale", torch.float32, 1, dev)
    require(scale.numel() == M // rows,
            f"scale has {scale.numel()} != {M // rows}")
    if zp is not None:
        check_tensor(zp, "zp", torch.float32, 1, dev)
        require(zp.numel() == M // rows, f"zp has {zp.numel()} != {M // rows}")
        check_tensor(w_rowsum, "w_rowsum", torch.int32, 1, dev)
        require(w_rowsum.numel() == N,
                f"w_rowsum has {w_rowsum.numel()} != {N}")
    if bias is not None:
        check_tensor(bias, "bias", torch.float32, 1, dev)
        require(bias.numel() == N, f"bias has {bias.numel()} != {N}")
    require(activation in HYBRID_ACTIVATIONS,
            f"hybrid fused activation {activation!r}")
    return M, K, N


def qmatmul_hybrid(a, b, w_scale, w_rowsum, zp, scale, bias=None, rows=1,
                   activation="NONE"):
    """out[M, N] = act((float32(A[M, K] . B[K, N]) - zp[m] * w_rowsum[n]) *
    (scale[m] * w_scale[n]) + bias[n]), float32, with zp[m] and scale[m]
    the entries of row m // rows.

    a, b int8; w_scale, scale, zp and bias float32 (zp None for
    symmetric rows, whose w_rowsum is then unused; bias None for none);
    w_rowsum int32 [N]; activation NONE, RELU or RELU6.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    global _hybrid_fn
    M, K, N = _check_hybrid(a, b, w_scale, w_rowsum, zp, scale, bias, rows,
                            activation)
    if not on_card(a):
        return qmatmul_hybrid_plain(a, b, w_scale, w_rowsum, zp, scale, bias,
                                    rows, activation)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if _hybrid_fn is None:
        _hybrid_fn = build.bind("qmatmul", "band_qmatmul_hybrid",
                                _HYBRID_ARGTYPES)
    plan = gemm_plan(M, N, K)

    def opt(t):
        return build.ptr(t) if t is not None else ctypes.c_void_p(None)

    build.launch(_hybrid_fn, a.device, build.ptr(a), build.ptr(b), opt(bias),
                 build.ptr(w_scale), opt(w_rowsum if zp is not None else None),
                 opt(zp), build.ptr(scale), build.ptr(out), M, N, K, rows,
                 HYBRID_ACTIVATIONS[activation], plan.tile, plan.splits,
                 plan.kt_per)
    hybrid_launches.add()
    return out
