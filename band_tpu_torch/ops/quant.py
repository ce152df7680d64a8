"""Quantization arithmetic for INT8/UINT8 inference, in native int64.

Bit-exact TFLite fixed-point requantization (the single-rounding
pipeline of TFLite >= 2.16, gemmlowp's double rounding, and ruy's
half-up rounding shift) on torch int64 tensors.  The JAX package builds
the 64-bit products from 32-bit limbs because the TPU's vector unit has
no 64-bit multiply (band_tpu/ops/quant.py:62-190); PyTorch and CUDA
have int64, so every product here is one multiply and every rounding
one add and one arithmetic shift.  The same formulas run inside the
CUDA kernels (ops/kernels/csrc/requant.cuh).

Which rounding each op uses: CONV_2D, DEPTHWISE_CONV_2D and
FULLY_CONNECTED requantize through ruy (``rounding="ruy"``), ADD and SUB
through single rounding, MUL and MEAN through double rounding
(ops/lowerings.py).  Fast numerics replace those epilogues with the
float32 forms below (``requantize_fast``).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

# "single" matches TFLite >= 2.16 (TFLITE_SINGLE_ROUNDING, the LiteRT
# default); "double" matches the gemmlowp pipeline of TFLite 2.9.2.
DEFAULT_ROUNDING = "single"
ROUNDING_CODES = {"single": 0, "double": 1, "ruy": 2}

IntLike = Union[int, np.ndarray, torch.Tensor]


# --------------------------------------------------------------------------
# Host-side multiplier decomposition (numpy, done once at prepare time)
# --------------------------------------------------------------------------

def quantize_multiplier(m: float) -> Tuple[int, int]:
    """Decompose a positive real multiplier into (q, shift) with
    m == q * 2^(shift - 31), q in [2^30, 2^31)."""
    if m == 0.0:
        return 0, 0
    mant, exp = math.frexp(m)  # m = mant * 2^exp, mant in [0.5, 1)
    q = int(round(mant * (1 << 31)))
    if q == (1 << 31):
        q //= 2
        exp += 1
    if exp < -31:
        # TFLite QuantizeMultiplier clamp: the multiplier underflows the
        # fixed-point range entirely
        return 0, 0
    return q, exp


def quantize_multipliers(ms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized quantize_multiplier for per-channel scales."""
    qs = np.empty(ms.shape, np.int32)
    shifts = np.empty(ms.shape, np.int32)
    for i, m in enumerate(np.ravel(ms)):
        q, s = quantize_multiplier(float(m))
        qs.flat[i] = q
        shifts.flat[i] = s
    return qs, shifts


def quantized_range(dtype: np.dtype) -> Tuple[int, int]:
    info = np.iinfo(dtype)
    return int(info.min), int(info.max)


def activation_range(
    activation: str, scale: float, zero_point: int, dtype: np.dtype
) -> Tuple[int, int]:
    """Clamp bounds of a fused activation in the quantized domain
    (tflite CalculateActivationRangeQuantized)."""
    qmin, qmax = quantized_range(dtype)

    def quantize(v: float) -> int:
        # TfLiteRound = half away from zero; Python's round() is
        # half-to-even and differs on exact ties
        r = v / scale
        return int(zero_point + math.floor(abs(r) + 0.5) * (1 if r >= 0 else -1))

    if activation == "RELU":
        qmin = max(qmin, quantize(0.0))
    elif activation == "RELU6":
        qmin = max(qmin, quantize(0.0))
        qmax = min(qmax, quantize(6.0))
    elif activation == "RELU_N1_TO_1":
        qmin = max(qmin, quantize(-1.0))
        qmax = min(qmax, quantize(1.0))
    elif activation in ("NONE", "TANH", "SIGN_BIT"):
        pass
    else:
        raise ValueError(f"unsupported fused activation {activation}")
    return qmin, qmax


# --------------------------------------------------------------------------
# Requantization in int64
# --------------------------------------------------------------------------

_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.complex64): torch.complex64,
}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (torch dtypes pass through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """The int32 two's-complement wrap of an int64 tensor (its low 32
    bits, sign-extended), kept as int64."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _as_i64(v: IntLike, like: torch.Tensor):
    """An int64 operand: a tensor on ``like``'s device, or a Python int
    for a scalar, so that a scalar multiplier costs no copy to the card
    (a copy from pageable host memory would wait for the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.int64)
    a = np.asarray(v, np.int64)
    if a.ndim == 0:
        return int(a)
    return torch.as_tensor(a, device=like.device)


def _pow2(e):
    """2^e for an int or an int64 tensor of exponents."""
    return 1 << e if isinstance(e, int) else torch.ones_like(e) << e


def multiply_by_quantized_multiplier(
    x: torch.Tensor, qm: IntLike, shift: IntLike, rounding: str = None
) -> torch.Tensor:
    """x * qm * 2^(shift-31) with TFLite-exact rounding; qm and shift
    broadcast against x.  Returns int32.

    single: floor((x*qm + 2^(t-1)) / 2^t), t = 31 - shift.
    double/ruy: x is first scaled by 2^max(shift, 0) in int32, then
    SaturatingRoundingDoublingHighMul and the rounding right shift by
    r = max(-shift, 0) are collapsed into one add and one shift of the
    product P (band_tpu/ops/quant.py:239-283):
      ruy:    floor((P + 2^30 + [r>0]*2^(30+r)) / 2^(31+r))
      double: the same minus [r>0 and P + 2^30 < 0] * 2^31 in the sum.
    SRDHM's saturating case needs qm == INT32_MIN, which no TFLite
    multiplier (qm in [0, 2^31)) reaches."""
    rounding = rounding or DEFAULT_ROUNDING
    x64 = x.to(torch.int64)
    qm64 = _as_i64(qm, x64)
    sh64 = _as_i64(shift, x64)
    if rounding == "single":
        t = 31 - sh64
        return wrap32((x64 * qm64 + _pow2(t - 1)) >> t).to(torch.int32)
    if rounding not in ("double", "ruy"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if isinstance(sh64, int):
        left, right = max(sh64, 0), max(-sh64, 0)
        gate = int(right > 0)
    else:
        left, right = sh64.clamp(min=0), (-sh64).clamp(min=0)
        gate = (right > 0).to(torch.int64)
    sum0 = wrap32(x64 << left) * qm64 + (1 << 30)
    add = gate * _pow2(30 + right)
    if rounding == "double":
        add = add - gate * ((sum0 < 0).to(torch.int64) << 31)
    return wrap32((sum0 + add) >> (31 + right)).to(torch.int32)


def requantize_exact(
    acc: torch.Tensor,
    qm: IntLike,
    shift: IntLike,
    out_zp: int,
    qmin: int,
    qmax: int,
    out_dtype,
    rounding: str = None,
) -> torch.Tensor:
    """int32 accumulator -> quantized output, bit-exact TFLite pipeline
    (the int32 add of the zero point wraps as it does in int32)."""
    scaled = multiply_by_quantized_multiplier(acc, qm, shift, rounding)
    out = wrap32(scaled.to(torch.int64) + int(out_zp))
    return out.clamp(int(qmin), int(qmax)).to(torch_dtype(out_dtype))


# --------------------------------------------------------------------------
# Fast numerics (RuntimeConfig.numerics == "fast"): float32 epilogues
# --------------------------------------------------------------------------

def _as_f32(v, like: torch.Tensor):
    """A float32 operand: a tensor on ``like``'s device, or a Python float
    for a scalar (float32 arithmetic rounds it to float32 either way)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    a = np.asarray(v, np.float32)
    if a.ndim == 0:
        return float(a)
    return torch.as_tensor(a, device=like.device)


def clamp_rounded(r: torch.Tensor, out_zp: int, qmin: int, qmax: int,
                  out_dtype) -> torch.Tensor:
    """clamp(r + out_zp, qmin, qmax) of a float32 tensor of integers ``r``,
    as ``out_dtype``.  The clamp comes first, to [qmin - out_zp, qmax -
    out_zp], so that the add stays exact however large r is; for |r| <
    2^31 this is band_tpu's int32 add and clip."""
    r = r.clamp(float(qmin - out_zp), float(qmax - out_zp)) + float(out_zp)
    return r.to(torch_dtype(out_dtype))


def requantize_fast(
    acc: torch.Tensor,
    multiplier,
    out_zp: int,
    qmin: int,
    qmax: int,
    out_dtype,
) -> torch.Tensor:
    """int32 accumulator -> quantized output through a float32 multiply
    and round half to even (band_tpu/ops/quant.py:344 requantize_fast).
    The accumulator converts to float32 with round to nearest; the
    multiply is one float32 product, so nothing is fused into an FMA.
    ``multiplier`` broadcasts against the last axis."""
    scaled = torch.round(acc.to(torch.float32) * _as_f32(multiplier, acc))
    return clamp_rounded(scaled, out_zp, qmin, qmax, out_dtype)


def round_ties_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics: round half away from zero (TfLiteRound)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def std_round(x: torch.Tensor) -> torch.Tensor:
    """std::round exactly: half away from zero, with no rounding of its
    own (``round_ties_away``'s |x| + 0.5 rounds up just below a half,
    0.49999997 -> 1, as band_tpu's does)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x),
                           torch.zeros_like(x))


# --------------------------------------------------------------------------
# Dynamic-range (hybrid) activations: float rows quantized at run time
# --------------------------------------------------------------------------

# band_tpu's row scales divide by the constants 255 and 127, which XLA
# compiles into a multiply by their float32 reciprocals: band_tpu's codes
# are those of the multiply, so the port multiplies too.
_INV_255 = float(np.float32(1.0 / 255.0))
_INV_127 = float(np.float32(1.0 / 127.0))


def asym_quant_rows(x: torch.Tensor):
    """Quantize a float32 tensor to int8 codes per leading index (a row:
    one request of a stacked window, or one of its own leading rows),
    asymmetrically, as TFLite's AsymmetricQuantizeFloats and band_tpu's
    ``_asym_quant_rows`` (band_tpu/ops/lowerings.py:406-422), in the float32
    operations band_tpu runs: scale = (max(rmax, 0) - min(rmin, 0)) *
    float32(1 / 255), zp = clip(round_ties_away(-128 - rmin / scale)), q =
    clip(round_ties_away(x / scale) + zp), each division by the scale a
    true one.  Returns float32 (q, zp, scale), zp and scale shaped [n, 1,
    ...] to broadcast over x; a degenerate (constant zero) row gets q = 0,
    zp = 0, scale = 1.  No row reads another's values."""
    n = x.shape[0]
    bshape = (n,) + (1,) * (x.dim() - 1)
    lo, hi = torch.aminmax(x.reshape(n, -1), dim=1)
    rmin = lo.clamp(max=0.0).reshape(bshape)
    rmax = hi.clamp(min=0.0).reshape(bshape)
    degenerate = rmax <= rmin
    scale = torch.where(degenerate, 1.0, (rmax - rmin) * _INV_255)
    zp = round_ties_away(-128.0 - rmin / scale).clamp(-128.0, 127.0)
    zp = torch.where(degenerate, 0.0, zp)
    q = (round_ties_away(x / scale) + zp).clamp(-128.0, 127.0)
    q = torch.where(degenerate, 0.0, q)
    return q, zp, scale


def sym_quant_rows(x2: torch.Tensor):
    """The symmetric form of a hybrid FULLY_CONNECTED's input (TFLite's
    SymmetricQuantizeFloats; band_tpu/ops/lowerings.py:984-991): per row
    of the 2-D ``x2``, scale = max|x| * float32(1 / 127), q =
    clip(round_ties_away(x / scale), -127, 127); a zero row gets q = 0,
    scale = 1.  Returns float32 (q, scale), scale [n, 1]."""
    amax = x2.abs().amax(dim=1, keepdim=True)
    degenerate = amax == 0.0
    scale = torch.where(degenerate, 1.0, amax * _INV_127)
    q = round_ties_away(x2 / scale).clamp(-127.0, 127.0)
    return torch.where(degenerate, 0.0, q), scale


def hybrid_quant_input(x: torch.Tensor):
    """The conv form of ``asym_quant_rows`` (band_tpu/ops/lowerings.py:
    425-430): the residual q - zp, float32 integers in [-255, 255], so
    that a zero-padded tap is the real 0.0 exactly, and the scale."""
    q, zp, scale = asym_quant_rows(x)
    return q - zp, scale


def dequantize(q: torch.Tensor, scale, zero_point) -> torch.Tensor:
    """(q - zero_point) * scale in float32."""
    return (q.to(torch.int32) - int(zero_point)).to(torch.float32) * \
        _as_f32(scale, q)


def quantize(x: torch.Tensor, scale, zero_point, dtype) -> torch.Tensor:
    """round_half_even(x / scale) + zero_point, clamped to the dtype, as
    band_tpu's quantize (band_tpu/ops/quant.py:407).  TFLite's own
    QUANTIZE mixes a half-even main loop with a half-away scalar tail;
    half-even matches the main loop."""
    qmin, qmax = quantized_range(np.dtype(dtype))
    s = _as_f32(scale, x)
    if not isinstance(s, torch.Tensor):
        # CUDA divides by a host scalar as a multiply by its reciprocal,
        # which can be an ulp off the quotient; a 0-d tensor on x's
        # device (filled there, no copy) gets the true division
        s = torch.full((), s, dtype=torch.float32, device=x.device)
    r = torch.round(x.to(torch.float32) / s)
    return clamp_rounded(r, int(zero_point), qmin, qmax, dtype)


def activation_lut(fn, in_scale: float, in_zp: int, out_scale: float,
                   out_zp: int, dtype) -> np.ndarray:
    """TFLite PopulateLookupTable (lite/kernels/activations.cc): the
    256-entry int8/uint8 table for a quantized elementwise activation,
    indexed by the uint8 reinterpretation of the input byte.  TfLiteRound
    is half away from zero."""
    dtype = np.dtype(dtype)
    info = np.iinfo(dtype)
    table = np.zeros(256, dtype)
    inv = np.float32(1.0) / np.float32(out_scale)
    for val in range(info.min, info.max + 1):
        deq = np.float32(in_scale) * np.float32(val - in_zp)
        tr = np.float32(fn(float(deq)))
        x = np.float32(tr * inv)
        rescaled = np.float32(np.sign(x) * np.floor(np.abs(x) + 0.5))
        quantized = int(rescaled) + out_zp
        table[val & 0xFF] = np.clip(quantized, info.min, info.max)
    return table


def apply_lut(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[i] = table[uint8(x[i])] (TFLite EvalUsingLookupTable)."""
    idx = x.view(torch.uint8) if x.dtype == torch.int8 else x
    return table[idx.to(torch.int64)]


# --------------------------------------------------------------------------
# TFLite integer SOFTMAX (bit-exact): a 256-entry float exp table and
# float32 row arithmetic with the row sum taken left to right
# (tflite optimized_ops PopulateSoftmaxLookupTable + Softmax).
# --------------------------------------------------------------------------

def softmax_table(input_scale: float, beta: float) -> np.ndarray:
    """PopulateSoftmaxLookupTable: table[255 - v] = expf(scale * v)."""
    scale = np.float32(-float(input_scale) * float(beta))
    table = np.empty(256, np.float32)
    for v in range(256):
        table[255 - v] = np.float32(math.exp(float(scale * np.float32(v))))
    return table
