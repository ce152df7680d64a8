"""Exact int8 depthwise convolution + fused TFLite requant (kernel B3)
and its plain version.

Replaces ``band_tpu/ops/pallas/qdwconv.py:114 qdwconv2d_exact`` (Pallas
kernel ``_qdwconv_kernel``).  On the TPU it ran only for narrow
boundary inputs; on the card it carries every int8 DEPTHWISE_CONV_2D,
with strides, dilation, depth multiplier > 1 and padding (taps outside
the image read ``x_zp``).  The CUDA source is ``csrc/qdwconv.cu``: one
thread per output element over its taps.  It does 9 MACs per output
byte, so the card's memory rate bounds it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import quant as Q
from . import build
from .common import (LaunchCount, check_epilogue, check_tensor, on_card,
                     pair, require)
from .qconv import conv_out_size

launches = LaunchCount("qdwconv2d_exact")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 22 + [ctypes.c_void_p]
_fn = None


def qdwconv2d_plain(x, w, bias, qm, shift, kh, kw, stride=(1, 1),
                    dilation=(1, 1), padding=((0, 0), (0, 0)), x_zp=0,
                    w_zp=0, out_zp=0, qmin=-128, qmax=127, rounding="ruy",
                    out_dtype=torch.int8):
    """The same function in plain PyTorch: a grouped float64 convolution
    of the x_zp-padded input (exact), per-channel window sums by a
    grouped all-ones convolution, the requant in int64."""
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
    acc = Q.wrap32(acc.permute(0, 2, 3, 1).to(torch.int64)
                   + bias.to(torch.int64))
    return Q.requantize_exact(acc, qm.to(torch.int64), shift.to(torch.int64),
                              out_zp, qmin, qmax, out_dtype, rounding)


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
    dev = x.device
    check_tensor(x, "x", torch.int8, 4, dev)
    check_tensor(w, "w", torch.int8, 2, dev)
    n, h, wd, ci = x.shape
    co = w.shape[1]
    require(w.shape[0] == kh * kw and co % ci == 0,
            f"w {tuple(w.shape)} != [{kh}*{kw}, {ci}*mult]")
    mult = co // ci
    sh, sw = pair(stride)
    dh, dw = pair(dilation)
    (pt, pb), (pl, pr) = padding
    require(min(sh, sw, dh, dw) >= 1 and min(pt, pb, pl, pr) >= 0,
            "strides and dilations >= 1, pads >= 0")
    oh = conv_out_size(h, kh, sh, dh, pt + pb)
    ow = conv_out_size(wd, kw, sw, dw, pl + pr)
    require(oh >= 1 and ow >= 1, "empty convolution output")
    qstride = check_epilogue(bias, qm, shift, co, dev, rounding, out_dtype)
    if not on_card(x):
        return qdwconv2d_plain(x, w, bias, qm, shift, kh, kw, (sh, sw),
                               (dh, dw), ((pt, pb), (pl, pr)), x_zp, w_zp,
                               out_zp, qmin, qmax, rounding, out_dtype)
    require(n * oh * ow * co < 2**31 and x.numel() < 2**31,
            "tensor too large for 32-bit indexing")
    out = torch.empty((n, oh, ow, co), dtype=out_dtype, device=dev)
    if _fn is None:
        _fn = build.bind("qdwconv", "band_qdwconv2d_exact", _ARGTYPES)
    build.launch(_fn, dev, build.ptr(x), build.ptr(w), build.ptr(bias),
                 build.ptr(qm), build.ptr(shift), build.ptr(out), n, h, wd,
                 ci, mult, oh, ow, kh, kw, sh, sw, dh, dw, pt, pl, qstride,
                 int(x_zp), int(w_zp), int(out_zp), int(qmin), int(qmax),
                 Q.ROUNDING_CODES[rounding])
    launches.add()
    return out
