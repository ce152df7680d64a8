"""Exact int8 NHWC convolution + fused TFLite requant (kernel B2) and
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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import quant as Q
from . import build
from .common import (LaunchCount, check_epilogue, check_tensor, on_card,
                     pair, require)

launches = LaunchCount("qconv2d_exact")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 22 + [ctypes.c_void_p]
_fn = None


def conv_out_size(size: int, k: int, stride: int, dil: int, pad_total: int):
    return (size + pad_total - (k - 1) * dil - 1) // stride + 1


def qconv2d_plain(x, w_km, bias, qm, shift, kh, kw, stride=(1, 1),
                  dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0, w_zp=0,
                  out_zp=0, qmin=-128, qmax=127, rounding="ruy",
                  out_dtype=torch.int8):
    """The same function in plain PyTorch: a float64 convolution of the
    x_zp-padded input (exact: integer sums far below 2^53), the window
    sum by an all-ones float64 convolution, the requant in int64."""
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
    acc = Q.wrap32(acc.permute(0, 2, 3, 1).to(torch.int64)
                   + bias.to(torch.int64))
    return Q.requantize_exact(acc, qm.to(torch.int64), shift.to(torch.int64),
                              out_zp, qmin, qmax, out_dtype, rounding)


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
    dev = x.device
    check_tensor(x, "x", torch.int8, 4, dev)
    check_tensor(w_km, "w_km", torch.int8, 2, dev)
    n, h, w, ci = x.shape
    require(w_km.shape[0] == kh * kw * ci,
            f"w_km {tuple(w_km.shape)} != [{kh}*{kw}*{ci}, Oc]")
    oc = w_km.shape[1]
    sh, sw = pair(stride)
    dh, dw = pair(dilation)
    (pt, pb), (pl, pr) = padding
    require(min(sh, sw, dh, dw) >= 1 and min(pt, pb, pl, pr) >= 0,
            "strides and dilations >= 1, pads >= 0")
    oh = conv_out_size(h, kh, sh, dh, pt + pb)
    ow = conv_out_size(w, kw, sw, dw, pl + pr)
    require(oh >= 1 and ow >= 1, "empty convolution output")
    qstride = check_epilogue(bias, qm, shift, oc, dev, rounding, out_dtype)
    if not on_card(x):
        return qconv2d_plain(x, w_km, bias, qm, shift, kh, kw, (sh, sw),
                             (dh, dw), ((pt, pb), (pl, pr)), x_zp, w_zp,
                             out_zp, qmin, qmax, rounding, out_dtype)
    require(n * oh * ow < 2**31 and x.numel() < 2**31,
            "tensor too large for 32-bit indexing")
    out = torch.empty((n, oh, ow, oc), dtype=out_dtype, device=dev)
    if _fn is None:
        _fn = build.bind("qconv", "band_qconv2d_exact", _ARGTYPES)
    build.launch(_fn, dev, build.ptr(x), build.ptr(w_km), build.ptr(bias),
                 build.ptr(qm), build.ptr(shift), build.ptr(out), n, h, w,
                 ci, oh, ow, oc, kh, kw, sh, sw, dh, dw, pt, pl, qstride,
                 int(x_zp), int(w_zp), int(out_zp), int(qmin), int(qmax),
                 Q.ROUNDING_CODES[rounding])
    launches.add()
    return out
