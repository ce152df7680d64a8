"""Int8 matmul + fused requant: the exact TFLite requant (kernel B1) and
the float32 requant of fast numerics (kernel B4), each with its plain
version.

B1 replaces ``band_tpu/ops/pallas/qmatmul.py:135 qmatmul_exact`` (Pallas
kernel ``_qmatmul_exact_kernel``): every exact int8 FULLY_CONNECTED and
1x1 stride-1 CONV_2D.  B4 replaces ``band_tpu/ops/pallas/qmatmul.py:42
qmatmul`` (Pallas kernel ``_qmatmul_kernel``): every fast one.  The CUDA
source of both is ``csrc/qmatmul.cu``: a tiled ``__dp4a`` GEMM with the
requant fused into its epilogue.  At the shapes MobileNetV2 gives it the
card's memory rate bounds it, not its int8 tensor-core rate; see PERF.md
for its times beside its bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import quant as Q
from . import build
from .common import (LaunchCount, check_epilogue, check_fast_epilogue,
                     check_tensor, on_card, require)

launches = LaunchCount("qmatmul_exact")
fast_launches = LaunchCount("qmatmul_fast")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_fn = None
_fast_fn = None


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
    build.launch(_fn, a.device, build.ptr(a), build.ptr(b), build.ptr(bias),
                 build.ptr(qm), build.ptr(shift), build.ptr(out), M, N, K,
                 qstride, int(w_zp), int(out_zp), int(qmin), int(qmax),
                 Q.ROUNDING_CODES[rounding])
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
    build.launch(_fast_fn, a.device, build.ptr(a), build.ptr(b),
                 build.ptr(bias), build.ptr(mult), build.ptr(out), M, N, K,
                 mstride, int(w_zp), int(out_zp), int(qmin), int(qmax))
    fast_launches.add()
    return out
