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
FULLY_CONNECTED requantize through ruy (``rounding="ruy"``), ADD through
single rounding, MEAN through double rounding (ops/lowerings.py).
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
