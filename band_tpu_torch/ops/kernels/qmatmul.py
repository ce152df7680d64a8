"""Exact int8 matmul + fused TFLite requant (kernel B1) and its plain
version.

Replaces ``band_tpu/ops/pallas/qmatmul.py:135 qmatmul_exact`` (Pallas
kernel ``_qmatmul_exact_kernel``): every int8 FULLY_CONNECTED and every
1x1 stride-1 CONV_2D.  The CUDA source is ``csrc/qmatmul.cu``: a tiled
``__dp4a`` GEMM with the requant fused into its epilogue.  At the
shapes MobileNetV2 gives it the card's memory rate bounds it, not its
int8 tensor-core rate; see PERF.md for its times beside its bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import quant as Q
from . import build
from .common import LaunchCount, check_epilogue, check_tensor, on_card, require

launches = LaunchCount("qmatmul_exact")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_fn = None


def qmatmul_plain(a, b, bias, qm, shift, out_zp=0, qmin=-128, qmax=127,
                  rounding="ruy", w_zp=0, out_dtype=torch.int8):
    """requant(A . B - w_zp * rowsum(A) + bias) in plain PyTorch: the
    product in float64 (exact: every partial sum is an integer far below
    2^53), the requant in int64.  Runs on any device."""
    af = a.to(torch.float64)
    acc = af @ b.to(torch.float64)
    if w_zp != 0:
        acc = acc - float(w_zp) * af.sum(dim=1, keepdim=True)
    # the kernel's int32 accumulator wraps; so does this one
    acc = Q.wrap32(acc.to(torch.int64) + bias.to(torch.int64))
    return Q.requantize_exact(acc, qm.to(torch.int64), shift.to(torch.int64),
                              out_zp, qmin, qmax, out_dtype, rounding)


def qmatmul_exact(a, b, bias, qm, shift, out_zp=0, qmin=-128, qmax=127,
                  rounding="ruy", w_zp=0, out_dtype=torch.int8):
    """out[M, N] = requant(A[M, K] . B[K, N] - w_zp * rowsum(A) + bias).

    a, b int8; bias int32 [N]; qm, shift int32 [N] or [1].  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global _fn
    out_dtype = Q.torch_dtype(out_dtype)
    dev = a.device
    check_tensor(a, "a", torch.int8, 2, dev)
    check_tensor(b, "b", torch.int8, 2, dev)
    M, K = a.shape
    require(b.shape[0] == K, f"a {tuple(a.shape)} and b {tuple(b.shape)}")
    N = b.shape[1]
    qstride = check_epilogue(bias, qm, shift, N, dev, rounding, out_dtype)
    if not on_card(a):
        return qmatmul_plain(a, b, bias, qm, shift, out_zp, qmin, qmax,
                             rounding, w_zp, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    if _fn is None:
        _fn = build.bind("qmatmul", "band_qmatmul_exact", _ARGTYPES)
    build.launch(_fn, dev, build.ptr(a), build.ptr(b), build.ptr(bias),
                 build.ptr(qm), build.ptr(shift), build.ptr(out), M, N, K,
                 qstride, int(w_zp), int(out_zp), int(qmin), int(qmax),
                 Q.ROUNDING_CODES[rounding])
    launches.add()
    return out
