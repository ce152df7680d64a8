"""TFLite's int8 kernels, written out plainly in exact arithmetic.

Every product of 8-bit values is summed in float64, where sums of
integers below 2**53 are exact in any order, and every requantization
runs in int64 as TFLite's fixed-point code does it.  The rounding of
each op follows the TFLite 2.21 CPU kernels whose outputs the model
files' goldens hold:

- CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED: ruy's pipeline (a doubling
  high multiply rounding half up, then a right shift rounding half up);
- ADD: single rounding (``TFLITE_SINGLE_ROUNDING``);
- MEAN, PRELU: gemmlowp's double rounding (SaturatingRoundingDoublingHighMul,
  then RoundingDivideByPOT);
- TRANSPOSE_CONV: ruy's for channels below 8 * floor(channels / 8) (the
  8-wide SIMD loop of optimized_ops::Quantize), double rounding for the
  rest (its scalar tail);
- SOFTMAX: the float32 exp table and row arithmetic of the optimized
  kernel, the row sum taken left to right.

Tensors are NHWC with the requests on axis 0; convolutions run in
NCHW with cuDNN switched off (its FFT and Winograd algorithms would
round) and TF32 off.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def quantize_multiplier(m: float) -> Tuple[int, int]:
    """TFLite's QuantizeMultiplier: m = q * 2**(shift - 31), q in
    [2**30, 2**31), q rounded half away from zero (TfLiteRound)."""
    if m == 0.0:
        return 0, 0
    mant, shift = math.frexp(m)
    q = int(math.floor(mant * (1 << 31) + 0.5))
    if q == 1 << 31:
        q //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    return q, shift


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31


def _as_i64(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=like.device)


def mbqm(x: torch.Tensor, qm, shift, rounding: str) -> torch.Tensor:
    """MultiplyByQuantizedMultiplier(x, qm, shift) of int64 ``x`` holding
    int32 values; ``qm`` and ``shift`` broadcast against it."""
    qm, shift = _as_i64(qm, x), _as_i64(shift, x)
    if rounding == "single":
        total = 31 - shift
        return (x * qm + (torch.ones_like(total) << (total - 1))) >> total
    left, right = shift.clamp(min=0), (-shift).clamp(min=0)
    prod = _wrap32(x * (torch.ones_like(left) << left)) * qm
    if rounding == "ruy":
        high = (prod + (1 << 30)) >> 31
        half = torch.where(right > 0, (torch.ones_like(right) << (right - 1)
                                       .clamp(min=0)), torch.zeros_like(right))
        return (high + half) >> right
    if rounding != "double":
        raise ValueError(f"unknown rounding {rounding!r}")
    nudge = torch.where(prod >= 0, torch.full_like(prod, 1 << 30),
                        torch.full_like(prod, 1 - (1 << 30)))
    high = torch.div(prod + nudge, 2 ** 31, rounding_mode="trunc")
    mask = (torch.ones_like(right) << right) - 1
    remainder = high & mask
    threshold = (mask >> 1) + (high < 0).to(torch.int64)
    return (high >> right) + (remainder > threshold).to(torch.int64)


def activation_range(act: str, scale: float, zp: int) -> Tuple[int, int]:
    """CalculateActivationRangeQuantized for int8 outputs: zp +
    TfLiteRound(f / scale), the division in float32."""
    def q(f: float) -> int:
        r = float(np.float32(f) / np.float32(scale))
        return int(zp) + int(math.copysign(math.floor(abs(r) + 0.5), r))

    lo, hi = -128, 127
    if act == "RELU":
        lo = max(lo, q(0.0))
    elif act == "RELU6":
        lo, hi = max(lo, q(0.0)), min(hi, q(6.0))
    elif act == "RELU_N1_TO_1":
        lo, hi = max(lo, q(-1.0)), min(hi, q(1.0))
    elif act != "NONE":
        raise ValueError(f"activation {act} not in the reference")
    return lo, hi


def conv_multipliers(s_in: float, s_w: np.ndarray, s_out: float,
                     channels: int):
    """Per-channel (qm, shift): double(s_in) * double(s_w[c]) /
    double(s_out); a per-tensor filter scale multiplies in float32
    first (GetQuantizedConvolutionMultipler)."""
    if s_w.size == 1:
        m = [float(np.float32(np.float32(s_in) * s_w[0])) / float(s_out)]
        m = m * channels
    else:
        m = [float(s_in) * float(s) / float(s_out) for s in s_w]
    qs = [quantize_multiplier(v) for v in m]
    return [q for q, _ in qs], [s for _, s in qs]


def requantize(acc: torch.Tensor, qm, shift, zp: int, lo: int, hi: int,
               rounding) -> torch.Tensor:
    """int64 accumulators [..., C] -> int8: per-channel MBQM + zp,
    clamped.  ``rounding`` is one name or one name per channel."""
    qm = torch.tensor(qm, dtype=torch.int64, device=acc.device)
    shift = torch.tensor(shift, dtype=torch.int64, device=acc.device)
    if isinstance(rounding, str):
        out = mbqm(acc, qm, shift, rounding)
    else:
        out = torch.empty_like(acc)
        for name in set(rounding):
            sel = [c for c, r in enumerate(rounding) if r == name]
            idx = torch.tensor(sel, device=acc.device)
            out[..., idx] = mbqm(acc[..., idx], qm[idx], shift[idx], name)
    return (out + zp).clamp(lo, hi).to(torch.int8)


def _real(x: torch.Tensor, zp: int) -> torch.Tensor:
    return x.to(torch.float64) - float(zp)


def same_padding(size: int, k: int, stride: int, dilation: int = 1):
    """TFLite's SAME padding (before, after) of one axis."""
    out = (size + stride - 1) // stride
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _sum_int(acc: torch.Tensor) -> torch.Tensor:
    """A float64 sum of integers as int64, checked exact."""
    out = acc.round().to(torch.int64)
    if acc.numel() and acc.abs().max().item() >= 2.0 ** 53:
        raise ArithmeticError("an accumulator left float64's exact range")
    return out


def _nchw_conv(x: torch.Tensor, w: torch.Tensor, pads, stride, dilation,
               groups: int) -> torch.Tensor:
    """Integer-valued float64 NHWC x and OIHW w -> int64 NHWC sums."""
    xp = x.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = pads
    xp = F.pad(xp, (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(xp, w, stride=stride, dilation=dilation, groups=groups)
    return _sum_int(y.permute(0, 2, 3, 1))


def conv2d(x, x_zp, w, bias, opts, multipliers, out_zp, lo, hi):
    """CONV_2D: x [N,H,W,Ci] int8, w [Co,kh,kw,Ci] integer-valued."""
    sh, sw = opts["stride_h"], opts["stride_w"]
    dh, dw = opts.get("dilation_h", 1), opts.get("dilation_w", 1)
    pads = _pads(x.shape[1:3], w.shape[1:3], (sh, sw), (dh, dw),
                 opts["padding"])
    wt = w.to(torch.float64).permute(0, 3, 1, 2).contiguous()
    acc = _nchw_conv(_real(x, x_zp), wt, pads, (sh, sw), (dh, dw), 1)
    acc = acc + bias
    return requantize(acc, *multipliers, out_zp, lo, hi, "ruy")


def depthwise_conv2d(x, x_zp, w, bias, opts, multipliers, out_zp, lo, hi):
    """DEPTHWISE_CONV_2D: w [1,kh,kw,Ci*m]; output channel c*m + j."""
    sh, sw = opts["stride_h"], opts["stride_w"]
    dh, dw = opts["dilation_h"], opts["dilation_w"]
    ci = x.shape[3]
    pads = _pads(x.shape[1:3], w.shape[1:3], (sh, sw), (dh, dw),
                 opts["padding"])
    wt = w.to(torch.float64)[0].permute(2, 0, 1).unsqueeze(1).contiguous()
    acc = _nchw_conv(_real(x, x_zp), wt, pads, (sh, sw), (dh, dw), ci)
    acc = acc + bias
    return requantize(acc, *multipliers, out_zp, lo, hi, "ruy")


def _pads(hw, khw, stride, dilation, padding):
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(same_padding(int(s), int(k), st, d)
                 for s, k, st, d in zip(hw, khw, stride, dilation))


def fully_connected(x, x_zp, w, bias, multipliers, out_zp, lo, hi):
    """FULLY_CONNECTED: x [N, K] int8, w [O, K] integer-valued."""
    acc = _real(x, x_zp) @ w.to(torch.float64).t()
    acc = _sum_int(acc) + bias
    return requantize(acc, *multipliers, out_zp, lo, hi, "ruy")


def transpose_conv(x, x_zp, w, bias, opts, out_hw, multipliers, out_zp,
                   lo, hi):
    """TRANSPOSE_CONV in its scatter form: out[y*s - pad + ky] +=
    (x - x_zp) * w[o, ky, kx, i], pad the SAME padding of the output
    size taken as a conv's input (ComputePaddingHeightWidth)."""
    sh, sw = opts["stride_h"], opts["stride_w"]
    co, kh, kw, _ = w.shape
    oh, ow = out_hw
    if opts["padding"] == "SAME":
        pt = same_padding(oh, kh, sh)[0]
        pl = same_padding(ow, kw, sw)[0]
    else:
        pt = pl = 0
    wt = w.to(torch.float64).permute(3, 0, 1, 2).contiguous()
    xr = _real(x, x_zp).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=False):
        full = F.conv_transpose2d(xr, wt, stride=(sh, sw))
    full = F.pad(full, (0, max(pl + ow - full.shape[3], 0),
                        0, max(pt + oh - full.shape[2], 0)))
    acc = _sum_int(full[:, :, pt:pt + oh, pl:pl + ow].permute(0, 2, 3, 1))
    acc = acc + bias
    k8 = co // 8 * 8
    rounding = ["ruy" if c < k8 else "double" for c in range(co)]
    return requantize(acc, *multipliers, out_zp, lo, hi, rounding)


def add(x1, t1, x2, t2, t_out, act: str):
    """ADD (add.cc Prepare and AddElementwise): both inputs shifted left
    by 20 and brought to twice the larger input scale, summed, scaled to
    the output; single rounding."""
    s1, s2 = float(t1.scale[0]), float(t2.scale[0])
    so = float(t_out.scale[0])
    twice = float(2 * np.float32(max(np.float32(s1), np.float32(s2))))
    q1, sh1 = quantize_multiplier(s1 / twice)
    q2, sh2 = quantize_multiplier(s2 / twice)
    qo, sho = quantize_multiplier(twice / float(np.float32((1 << 20)
                                                           * np.float32(so))))
    a1 = (x1.to(torch.int64) - int(t1.zero_point[0])) << 20
    a2 = (x2.to(torch.int64) - int(t2.zero_point[0])) << 20
    raw = mbqm(a1, q1, sh1, "single") + mbqm(a2, q2, sh2, "single")
    out = mbqm(raw, qo, sho, "single") + int(t_out.zero_point[0])
    lo, hi = activation_range(act, so, int(t_out.zero_point[0]))
    return out.clamp(lo, hi).to(torch.int8)


def mean(x, t_in, t_out, axes, keep_dims: bool):
    """MEAN (reference_ops::QuantizedMeanOrSum): the multiplier of s_in /
    s_out shifted left by min(floor(log2 n), 32, 31 + shift) and divided
    by n, applied to sum(x) - zp_in * n; double rounding."""
    axes = sorted(a % x.dim() for a in axes)
    n = 1
    for a in axes:
        n *= x.shape[a]
    qm, sh = quantize_multiplier(float(t_in.scale[0]) / float(t_out.scale[0]))
    s = min(n.bit_length() - 1, 32, 31 + sh)
    qm, sh = (qm << s) // n, sh - s
    total = x.to(torch.int64).sum(dim=axes, keepdim=keep_dims)
    out = mbqm(total - int(t_in.zero_point[0]) * n, qm, sh, "double")
    return (out + int(t_out.zero_point[0])).clamp(-128, 127).to(torch.int8)


def prelu(x, t_in, alpha, t_alpha, t_out):
    """PRELU (reference_ops::BroadcastPrelu4DSlow): x - zp >= 0 through
    M1 = s_in / s_out, else (x - zp) * (alpha - zp_alpha) through M2 =
    s_in * s_alpha / s_out, both multipliers in float32; double rounding."""
    f = np.float32
    si, sa, so = f(t_in.scale[0]), f(t_alpha.scale[0]), f(t_out.scale[0])
    q1, sh1 = quantize_multiplier(float(si / so))
    q2, sh2 = quantize_multiplier(float(f(si * sa) / so))
    xi = x.to(torch.int64) - int(t_in.zero_point[0])
    a = alpha.to(torch.int64) - int(t_alpha.zero_point[0])
    pos = mbqm(xi, q1, sh1, "double")
    neg = mbqm(xi * a, q2, sh2, "double")
    out = torch.where(xi >= 0, pos, neg) + int(t_out.zero_point[0])
    return out.clamp(-128, 127).to(torch.int8)


def softmax_table(s_in: float, beta: float) -> np.ndarray:
    """PopulateSoftmaxLookupTable: table[255 - v] = expf(-s_in * beta *
    v), expf correctly rounded (exp in float64, one rounding)."""
    scale = np.float32(-np.float32(s_in) * np.float32(beta))
    table = np.empty(256, np.float32)
    for v in range(256):
        table[255 - v] = np.float32(math.exp(float(scale * np.float32(v))))
    return table


def softmax(x, t_in, t_out, beta: float):
    """SOFTMAX int8 -> int8 over the last axis (optimized_ops::Softmax
    with the table): e = table[255 - max + x], the row sum in float32
    left to right, out = int(e / (sum * s_out) + 0.5) + zp, clamped."""
    table = torch.from_numpy(softmax_table(float(t_in.scale[0]), beta))
    xi = x.to(torch.int64).cpu()
    e = table[255 - xi.max(dim=-1, keepdim=True).values + xi].numpy()
    total = np.zeros(e.shape[:-1], np.float32)
    for j in range(e.shape[-1]):
        total = (total + e[..., j]).astype(np.float32)
    inv = (np.float32(1.0) / (total * np.float32(t_out.scale[0]))).astype(
        np.float32)
    prob = (e * inv[..., None]).astype(np.float32)
    q = (prob + np.float32(0.5)).astype(np.int32).astype(np.int64)
    q = np.clip(q + int(t_out.zero_point[0]), -128, 127).astype(np.int8)
    return torch.from_numpy(q).to(x.device)
