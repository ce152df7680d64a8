"""Int8 NHWC convolution + fused requant: the exact TFLite requant
(kernel B2) and its fast-numerics instance (float32 requant), each with
its plain version.

Replaces ``band_tpu/ops/pallas/qconv.py:152 qconv2d_exact`` (Pallas
kernel ``_qconv_kernel``).  That kernel took a zero-point-padded input
at stride 1; this one adds stride, dilation and padding (taps outside
the image read ``x_zp``), because on the card it carries every CONV_2D
that is not a 1x1 stride-1 matmul: PyTorch has no int8 convolution on
CUDA, and cuDNN runs float32 convolutions in TF32 by default.  The CUDA
source is ``csrc/qconv.cu``, an implicit GEMM over the taps (dy, dx,
ci) that shares the tile loop of ``csrc/qgemm.cuh``.  MobileNetV2's
stem (K = 27) is bound by memory and the 3-channel gather.

``qconv2d_fast`` is the same kernel with the float32 epilogue of fast
numerics, which on the TPU was XLA's conv followed by
``requantize_fast`` (band_tpu/ops/lowerings.py:563-575).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import quant as Q
from . import build
from .common import (LaunchCount, check_epilogue, check_fast_epilogue,
                     check_tensor, on_card, pair, require)

launches = LaunchCount("qconv2d_exact")
fast_launches = LaunchCount("qconv2d_fast")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 22 + [ctypes.c_void_p]
_FAST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 21 + [ctypes.c_void_p]
_fn = None
_fast_fn = None


def conv_out_size(size: int, k: int, stride: int, dil: int, pad_total: int):
    return (size + pad_total - (k - 1) * dil - 1) // stride + 1


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
    if _fn is None:
        _fn = build.bind("qconv", "band_qconv2d_exact", _ARGTYPES)
    build.launch(_fn, x.device, build.ptr(x), build.ptr(w_km),
                 build.ptr(bias), build.ptr(qm), build.ptr(shift),
                 build.ptr(out), n, h, w, ci, oh, ow, oc, kh, kw, sh, sw, dh,
                 dw, pt, pl, qstride, int(x_zp), int(w_zp), int(out_zp),
                 int(qmin), int(qmax), Q.ROUNDING_CODES[rounding])
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
    if _fast_fn is None:
        _fast_fn = build.bind("qconv", "band_qconv2d_fast", _FAST_ARGTYPES)
    build.launch(_fast_fn, x.device, build.ptr(x), build.ptr(w_km),
                 build.ptr(bias), build.ptr(mult), build.ptr(out), n, h, w,
                 ci, oh, ow, oc, kh, kw, sh, sw, dh, dw, pt, pl, mstride,
                 int(x_zp), int(w_zp), int(out_zp), int(qmin), int(qmax))
    fast_launches.add()
    return out
