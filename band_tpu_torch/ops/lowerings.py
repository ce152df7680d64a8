"""PyTorch lowerings of the int8 TFLite ops of the serving path.

Each op is a numpy ``prepare`` (run once per subgraph: weight layout,
zero-point corrections folded into the bias, fixed-point multipliers)
and a lowering that runs on torch tensors.  Every int8 CONV_2D,
DEPTHWISE_CONV_2D and FULLY_CONNECTED goes through a hand-written kernel
(ops/kernels), which on a CPU tensor runs its plain PyTorch version;
quantized SOFTMAX goes through its kernel too, and every int8
TRANSPOSE_CONV runs as phase convolutions on the conv kernel.  ADD,
SUB, MUL, MEAN, RELU, RELU6 and the int8 QUANTIZE are plain PyTorch in
int64, the pools in floating point (exact for 8-bit values), RESHAPE a
view, LOGISTIC, TANH and ELU TFLite's 256-entry tables, the exact int8
PRELU and LEAKY_RELU tables of TFLite's fixed-point kernels.  The
structural ops (SHAPE, STRIDED_SLICE, SLICE, PACK, TRANSPOSE,
CONCATENATION, the pads, splits, depth/space moves and nearest resize)
move bytes; RESIZE_BILINEAR, BATCH_MATMUL, SQUARED_DIFFERENCE and the
float unary table run band_tpu's float fallback (as_float, a float32
op, store_real).

Numerics: ``prepare(graph, op, exact)`` with exact=False (fast numerics)
gives CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED a float32 ``mult``
instead of ``qm``/``shift``, ADD and SUB the float32 rescales ``f1``/``f2``
and MUL ``fm``, as band_tpu's prepares do, and PRELU and LEAKY_RELU
band_tpu's float form instead of TFLite's tables; each lowering takes
the fast form when its prepared params hold those keys (the fast
kernels qmatmul_fast, qconv2d_fast and qdwconv2d_fast for the convs,
TRANSPOSE_CONV and FC).

Counterparts: band_tpu/ops/lowerings.py.  The TPU routing gates there
(256-row tiles and M padding, the C<=64 boundary-only depthwise rule,
split and dense-diagonal weights, batch hints, fusion islands) are
lowering choices for the TPU, not semantics, and have no counterpart.

Batches: a window of B requests runs as one call with the requests
stacked on the leading axis, so a tensor whose model shape is
[d0, ...] arrives as [B*d0, ...].  Lowerings keep that axis: shapes
taken from the model are rescaled by ``_stacked_shape``, no op reduces
over axis 0, and an op that would index, slice, split, pack, pad,
permute or concatenate along it is refused when the program is built
(a LoweringError naming the op), unless its operand is a shape value
(``_is_shape_value``) and carries no requests.

The op set is that of the slices so far (MobileNetV2, the tests/data
CNNs, quant_act_int8, the SSD backbones, tconv_int8, attention_int8,
cnn_ops_int8 and FSRCNN); float and hybrid variants of the conv-family
ops raise LoweringError.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import LoweringError
from ..ir.graph import Graph, OpNode, QuantParams, TensorDef
from . import quant as Q
from .kernels import (lut_softmax, qconv2d_exact, qconv2d_fast,
                      qdwconv2d_exact, qdwconv2d_fast, qmatmul_exact,
                      qmatmul_fast)
from .registry import register


# --------------------------------------------------------------------------
# Lowering context
# --------------------------------------------------------------------------

class LowerCtx:
    """State threaded through one subgraph run."""

    def __init__(self, graph: Graph, params: Dict[str, torch.Tensor],
                 meta: Dict[str, Any]):
        self.graph = graph
        self.params = params
        self.meta = meta
        self.env: Dict[int, torch.Tensor] = {}

    def arr(self, tid: int) -> torch.Tensor:
        if tid in self.env:
            return self.env[tid]
        td = self.graph.tensor(tid)
        key = f"t{tid}"
        if key in self.params:
            return self.params[key]
        if td.is_constant:
            raise LoweringError(
                f"constant tensor {tid} ({td.name}) not prepared as param"
            )
        raise LoweringError(f"tensor {tid} ({td.name}) undefined during run")

    def static(self, tid: int) -> np.ndarray:
        td = self.graph.tensor(tid)
        if not td.is_constant:
            raise LoweringError(
                f"tensor {tid} ({td.name}) must be a constant for this op"
            )
        return td.data

    def qp(self, tid: int) -> Optional[QuantParams]:
        return self.graph.tensor(tid).quant

    def is_quantized(self, tid: int) -> bool:
        td = self.graph.tensor(tid)
        return td.quant is not None and td.dtype.kind in ("i", "u")

    def set(self, tid: int, value: torch.Tensor) -> None:
        self.env[tid] = value

    def param(self, op: OpNode, name: str) -> torch.Tensor:
        return self.params[f"op{op.index}/{name}"]

    def smeta(self, op: OpNode, name: str):
        return self.meta[f"op{op.index}/{name}"]


# --------------------------------------------------------------------------
# Shared helpers
# --------------------------------------------------------------------------

def _scalar_qp(qp: QuantParams) -> Tuple[float, int]:
    return float(qp.scale[0]), int(qp.zero_point[0])


def _to_int8_domain(x: torch.Tensor) -> torch.Tensor:
    """Shift uint8 tensors into int8 (v - 128, by flipping the top bit);
    the prepared zero points are already shifted to match."""
    if x.dtype == torch.uint8:
        return (x ^ 128).view(torch.int8)
    return x


def _same_pads(in_size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    eff_k = (k - 1) * dilation + 1
    out = -(-in_size // stride)
    total = max((out - 1) * stride + eff_k - in_size, 0)
    before = total // 2
    return before, total - before


def _conv_pads(opts, in_h, in_w, kh, kw) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if opts["padding"] == "SAME":
        ph = _same_pads(in_h, kh, opts["stride_h"], opts.get("dilation_h", 1))
        pw = _same_pads(in_w, kw, opts["stride_w"], opts.get("dilation_w", 1))
        return ph, pw
    return (0, 0), (0, 0)


def _stacked_shape(x: torch.Tensor, in_td: TensorDef, shape) -> Tuple[int, ...]:
    """Model shape ``shape`` for the stack of requests ``x`` carries:
    x has B times the leading extent of its model shape ``in_td.shape``,
    and so does the result.  (Requests stay contiguous blocks of equal
    size, so a row-major reshape keeps them apart.)"""
    shape = tuple(int(s) for s in shape)
    base = int(in_td.shape[0]) if len(in_td.shape) else 1
    if not shape or x.dim() == 0 or base <= 0:
        return shape
    b = x.shape[0] // base
    return (b * shape[0],) + shape[1:]


def _require_int8_path(graph: Graph, op: OpNode) -> None:
    x_td = graph.tensor(op.inputs[0])
    if x_td.quant is None or x_td.dtype.kind == "f":
        raise LoweringError(
            f"{op.opname} op {op.index}: float and hybrid variants are not "
            "ported to PyTorch yet (int8/uint8 only)"
        )


def _requant(ctx: LowerCtx, op: OpNode, out_td: TensorDef):
    """(fast, epilogue tensors, keyword arguments) of a conv-family kernel
    call: bias and mult for the fast kernels when prepare produced a
    ``mult``, else bias, qm and shift and the rounding for the exact ones."""
    kw = dict(
        out_zp=int(ctx.smeta(op, "out_zp")),
        qmin=int(ctx.smeta(op, "qmin")),
        qmax=int(ctx.smeta(op, "qmax")),
        w_zp=int(ctx.smeta(op, "w_zp")),
        out_dtype=Q.torch_dtype(out_td.dtype),
    )
    if f"op{op.index}/mult" in ctx.params:
        return True, (ctx.param(op, "bias"), ctx.param(op, "mult")), kw
    kw["rounding"] = ctx.smeta(op, "rounding")
    return False, (ctx.param(op, "bias"), ctx.param(op, "qm"),
                   ctx.param(op, "shift")), kw


# --------------------------------------------------------------------------
# CONV_2D
# --------------------------------------------------------------------------

def _prepare_conv_common(
    graph: Graph,
    op: OpNode,
    w_td: TensorDef,
    w_hwio: np.ndarray,
    sum_axes: Tuple[int, ...],
    k_taps: int,
    exact: bool,
) -> Dict[str, Any]:
    """Shared quantized-conv prep: int8 weights + folded bias + multipliers.

    acc_true = conv(x', w') - w_zp * S(x'_pad) - x_zp * sum(w') + k*x_zp*w_zp
    The x_zp terms are static -> folded into bias.  w_hwio is the kernel
    already in HWIO layout; sum_axes are the axes summed per out-channel.
    """
    g = graph
    x_td = g.tensor(op.inputs[0])
    out_td = g.tensor(op.outputs[0])
    xs, xzp = _scalar_qp(x_td.quant)
    os_, ozp = _scalar_qp(out_td.quant)
    wq = w_td.quant
    # shift into int8 domain
    w_i = w_hwio.astype(np.int32)
    wzp_arr = wq.zero_point.astype(np.int32)
    if w_td.dtype == np.uint8:
        w_i = w_i - 128
        wzp_arr = wzp_arr - 128
        xzp -= 128
    w_i8 = w_i.astype(np.int8)
    wzp = int(wzp_arr[0]) if wzp_arr.size == 1 else 0
    if wzp_arr.size > 1 and np.any(wzp_arr != 0):
        raise LoweringError("per-channel weights must have zero_point 0")

    bias = np.zeros(w_hwio.shape[-1], np.int32)
    if len(op.inputs) > 2 and op.inputs[2] >= 0:
        bias = g.tensor(op.inputs[2]).data.astype(np.int32).copy()
    w_sum = w_i.sum(axis=sum_axes).astype(np.int64)
    bias_eff = (
        bias.astype(np.int64) - xzp * w_sum + k_taps * xzp * wzp
    ).astype(np.int32)

    # TFLite multiplier precision semantics (bit-exactness matters):
    # per-tensor: double(float32(s_x * s_w)) / double(s_out)
    #   (GetQuantizedConvolutionMultipler does the product in float)
    # per-channel: double(s_x) * double(s_w_i) / double(s_out)
    if wq.scale.size == 1:
        prod = np.float64(np.float32(np.float32(xs) * wq.scale[0]))
        multipliers = np.array([prod / np.float64(os_)])
    else:
        multipliers = (
            np.float64(xs) * wq.scale.astype(np.float64)
        ) / np.float64(os_)
    out = {
        "w": w_i8,
        "bias": bias_eff,
        "x_zp": xzp,
        "w_zp": wzp,
    }
    if exact:
        qm, shift = Q.quantize_multipliers(multipliers)
        out["qm"] = qm
        out["shift"] = shift
    else:
        out["mult"] = multipliers.astype(np.float32)
    act = op.options.get("activation", "NONE")
    qmin, qmax = Q.activation_range(act, os_, ozp, out_td.dtype)
    out["qmin"], out["qmax"], out["out_zp"] = qmin, qmax, ozp
    # conv kernels requantize through ruy's pipeline (SRDHM + half-up
    # rounding shift), the cpu_backend_gemm path in TFLite 2.9+
    out["rounding"] = "ruy"
    return out


def _prepare_conv2d(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    _require_int8_path(graph, op)
    w_td = graph.tensor(op.inputs[1])
    w_hwio = np.transpose(w_td.data, (1, 2, 3, 0))  # OHWI -> HWIO
    kh, kw, ci, _ = w_hwio.shape
    return _prepare_conv_common(
        graph, op, w_td, w_hwio, sum_axes=(0, 1, 2), k_taps=kh * kw * ci,
        exact=exact,
    )


@register("CONV_2D", prepare=_prepare_conv2d)
def _conv2d(ctx: LowerCtx, op: OpNode) -> None:
    """1x1 stride-1 unpadded convs are matmuls (kernel B1, or B4 with fast
    numerics); every other conv runs the implicit-GEMM conv kernel (B2,
    or its fast instance) with its own padding."""
    x = _to_int8_domain(ctx.arr(op.inputs[0]))
    w = ctx.param(op, "w")  # HWIO int8
    out_td = ctx.graph.tensor(op.outputs[0])
    opts = op.options
    kh, kw, ci, oc = w.shape
    ph, pw = _conv_pads(opts, x.shape[1], x.shape[2], kh, kw)
    dil = (opts.get("dilation_h", 1), opts.get("dilation_w", 1))
    strides = (opts["stride_h"], opts["stride_w"])
    fast, epi, rq = _requant(ctx, op, out_td)
    if (kh, kw) == (1, 1) and strides == (1, 1) and ph == (0, 0) and pw == (0, 0):
        n, h, w_, _ = x.shape
        out = (qmatmul_fast if fast else qmatmul_exact)(
            x.reshape(n * h * w_, ci), w.reshape(ci, oc), *epi, **rq)
        ctx.set(op.outputs[0], out.reshape(n, h, w_, oc))
        return
    out = (qconv2d_fast if fast else qconv2d_exact)(
        x, w.reshape(kh * kw * ci, oc), *epi, kh=kh, kw=kw, stride=strides,
        dilation=dil, padding=(ph, pw), x_zp=int(ctx.smeta(op, "x_zp")), **rq,
    )
    ctx.set(op.outputs[0], out)


# --------------------------------------------------------------------------
# DEPTHWISE_CONV_2D
# --------------------------------------------------------------------------

def _prepare_dwconv2d(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    _require_int8_path(graph, op)
    w_td = graph.tensor(op.inputs[1])
    # TFLite layout [1, kh, kw, out_c] -> HWIO [kh, kw, 1, out_c]
    w_hwio = np.transpose(w_td.data, (1, 2, 0, 3))
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    return _prepare_conv_common(
        graph, op, w_td, w_hwio, sum_axes=(0, 1, 2), k_taps=kh * kw,
        exact=exact,
    )


@register("DEPTHWISE_CONV_2D", prepare=_prepare_dwconv2d)
def _dwconv2d(ctx: LowerCtx, op: OpNode) -> None:
    """Every int8 depthwise conv runs kernel B3, or its fast instance (any
    stride, dilation and depth multiplier; padded taps read x_zp)."""
    x = _to_int8_domain(ctx.arr(op.inputs[0]))
    w = ctx.param(op, "w")  # HWIO [kh, kw, 1, C*mult] int8
    out_td = ctx.graph.tensor(op.outputs[0])
    opts = op.options
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _conv_pads(opts, x.shape[1], x.shape[2], kh, kw)
    fast, epi, rq = _requant(ctx, op, out_td)
    out = (qdwconv2d_fast if fast else qdwconv2d_exact)(
        x, w.reshape(kh * kw, w.shape[-1]), *epi, kh=kh, kw=kw,
        stride=(opts["stride_h"], opts["stride_w"]),
        dilation=(opts.get("dilation_h", 1), opts.get("dilation_w", 1)),
        padding=(ph, pw), x_zp=int(ctx.smeta(op, "x_zp")), **rq,
    )
    ctx.set(op.outputs[0], out)


# --------------------------------------------------------------------------
# FULLY_CONNECTED
# --------------------------------------------------------------------------

def _prepare_fc(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    w_td = graph.tensor(op.inputs[1])
    if w_td.data is None:
        raise LoweringError(
            f"FULLY_CONNECTED op {op.index}: runtime weights are not ported "
            "to PyTorch yet"
        )
    _require_int8_path(graph, op)
    w = w_td.data  # [out, in]
    return _prepare_conv_common(
        graph, op, w_td, np.transpose(w, (1, 0)), sum_axes=(0,),
        k_taps=w.shape[1], exact=exact,
    )


@register("FULLY_CONNECTED", prepare=_prepare_fc)
def _fully_connected(ctx: LowerCtx, op: OpNode) -> None:
    """Every int8 FC runs kernel B1 (B4 with fast numerics) on the
    input's rows."""
    x_raw = ctx.arr(op.inputs[0])
    x = _to_int8_domain(x_raw)
    out_td = ctx.graph.tensor(op.outputs[0])
    fast, epi, rq = _requant(ctx, op, out_td)
    out = (qmatmul_fast if fast else qmatmul_exact)(
        x.reshape(-1, x.shape[-1]), ctx.param(op, "w"), *epi, **rq)
    in_td = ctx.graph.tensor(op.inputs[0])
    ctx.set(op.outputs[0],
            out.reshape(_stacked_shape(x_raw, in_td, out_td.shape)))


# --------------------------------------------------------------------------
# ADD, SUB, MUL
# --------------------------------------------------------------------------

def _require_quantized_binary(graph: Graph, op: OpNode) -> None:
    t1, t2 = graph.tensor(op.inputs[0]), graph.tensor(op.inputs[1])
    out_td = graph.tensor(op.outputs[0])
    if (t1.quant is None or t1.dtype.kind == "f" or t2.quant is None
            or out_td.quant is None):
        raise LoweringError(
            f"{op.opname} op {op.index}: float variants are not ported to "
            "PyTorch yet"
        )


def _constant_inputs(graph: Graph, op: OpNode) -> Dict[str, Any]:
    return {f"c{tid}": graph.tensor(tid).data for tid in op.inputs
            if graph.tensor(tid).is_constant}


def _prepare_addsub(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    _require_quantized_binary(graph, op)
    t1, t2 = graph.tensor(op.inputs[0]), graph.tensor(op.inputs[1])
    out_td = graph.tensor(op.outputs[0])
    s1, zp1 = _scalar_qp(t1.quant)
    s2, zp2 = _scalar_qp(t2.quant)
    so, zpo = _scalar_qp(out_td.quant)
    left_shift = 20
    twice_max = 2.0 * max(s1, s2)
    qm1, sh1 = Q.quantize_multiplier(s1 / twice_max)
    qm2, sh2 = Q.quantize_multiplier(s2 / twice_max)
    qmo, sho = Q.quantize_multiplier(twice_max / ((1 << left_shift) * so))
    act = op.options.get("activation", "NONE")
    qmin, qmax = Q.activation_range(act, so, zpo, out_td.dtype)
    d = {
        "zp1": zp1, "zp2": zp2, "zpo": zpo,
        "qm1": np.int32(qm1), "sh1": sh1,
        "qm2": np.int32(qm2), "sh2": sh2,
        "qmo": np.int32(qmo), "sho": sho,
        "left_shift": left_shift, "qmin": qmin, "qmax": qmax,
    }
    if not exact:
        # fast numerics: one float32 rescale per input and one round in
        # place of the three fixed-point chains (band_tpu
        # lowerings.py:1130-1135)
        d["f1"] = float(s1 / so)
        d["f2"] = float(s2 / so)
    d.update(_constant_inputs(graph, op))
    return d


def _operand(ctx: LowerCtx, op: OpNode, tid: int) -> torch.Tensor:
    """An input of ``op``: its prepared constant (``_constant_inputs``) or
    the runtime value."""
    key = f"op{op.index}/c{tid}"
    return ctx.params[key] if key in ctx.params else ctx.arr(tid)


def _binary_inputs(ctx: LowerCtx, op: OpNode):
    return [_operand(ctx, op, tid) for tid in op.inputs[:2]]


def _store_clamped(ctx: LowerCtx, op: OpNode, r: torch.Tensor) -> None:
    """Output = clamp(r + zpo, qmin, qmax) of float32 integers ``r``."""
    out_td = ctx.graph.tensor(op.outputs[0])
    ctx.set(op.outputs[0], Q.clamp_rounded(
        r, int(ctx.smeta(op, "zpo")), int(ctx.smeta(op, "qmin")),
        int(ctx.smeta(op, "qmax")), out_td.dtype))


def _addsub(ctx: LowerCtx, op: OpNode, sign: int) -> None:
    """TFLite's quantized ADD/SUB: both inputs rescaled to a common scale
    (x - zp) << 20 through single-rounding MBQM, summed (or subtracted),
    rescaled to the output, all in int64.  Fast numerics: round_half_even
    ((x1 - zp1) * f1 + sign * (x2 - zp2) * f2) + zpo in float32, band_tpu's
    form (every product and the sum rounded once, no FMA; the
    differences of 8-bit values are exact in float32)."""
    out_td = ctx.graph.tensor(op.outputs[0])
    x1, x2 = _binary_inputs(ctx, op)
    if f"op{op.index}/f1" in ctx.meta:
        p1 = (x1.to(torch.float32) - float(ctx.smeta(op, "zp1"))) * \
            float(ctx.smeta(op, "f1"))
        p2 = (x2.to(torch.float32) - float(ctx.smeta(op, "zp2"))) * \
            float(ctx.smeta(op, "f2"))
        _store_clamped(ctx, op, torch.round(p1 + p2 if sign > 0 else p1 - p2))
        return
    ls = int(ctx.smeta(op, "left_shift"))
    a1 = x1.to(torch.int64) - int(ctx.smeta(op, "zp1"))
    a2 = x2.to(torch.int64) - int(ctx.smeta(op, "zp2"))
    s1 = Q.multiply_by_quantized_multiplier(
        a1 << ls, int(ctx.smeta(op, "qm1")), int(ctx.smeta(op, "sh1")))
    s2 = Q.multiply_by_quantized_multiplier(
        a2 << ls, int(ctx.smeta(op, "qm2")), int(ctx.smeta(op, "sh2")))
    s1, s2 = s1.to(torch.int64), s2.to(torch.int64)
    raw = s1 + s2 if sign > 0 else s1 - s2
    out = Q.multiply_by_quantized_multiplier(
        raw, int(ctx.smeta(op, "qmo")), int(ctx.smeta(op, "sho"))
    ).to(torch.int64) + int(ctx.smeta(op, "zpo"))
    out = out.clamp(int(ctx.smeta(op, "qmin")), int(ctx.smeta(op, "qmax")))
    ctx.set(op.outputs[0], out.to(Q.torch_dtype(out_td.dtype)))


@register("ADD", prepare=_prepare_addsub)
def _add(ctx: LowerCtx, op: OpNode) -> None:
    _addsub(ctx, op, +1)


@register("SUB", prepare=_prepare_addsub)
def _sub(ctx: LowerCtx, op: OpNode) -> None:
    _addsub(ctx, op, -1)


def _prepare_mul(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    _require_quantized_binary(graph, op)
    t1, t2 = graph.tensor(op.inputs[0]), graph.tensor(op.inputs[1])
    out_td = graph.tensor(op.outputs[0])
    s1, zp1 = _scalar_qp(t1.quant)
    s2, zp2 = _scalar_qp(t2.quant)
    so, zpo = _scalar_qp(out_td.quant)
    # TFLite computes the MUL multiplier fully in float32 before widening
    fm = float(np.float32(np.float32(s1) * np.float32(s2) / np.float32(so)))
    qm, sh = Q.quantize_multiplier(fm)
    act = op.options.get("activation", "NONE")
    qmin, qmax = Q.activation_range(act, so, zpo, out_td.dtype)
    d = {"zp1": zp1, "zp2": zp2, "zpo": zpo, "qm": np.int32(qm), "sh": sh,
         "qmin": qmin, "qmax": qmax}
    if not exact:
        d["fm"] = fm
    d.update(_constant_inputs(graph, op))
    return d


@register("MUL", prepare=_prepare_mul)
def _mul(ctx: LowerCtx, op: OpNode) -> None:
    """TFLite's quantized MUL: (x1 - zp1) * (x2 - zp2) requantized by
    double-rounding MBQM (TFLite's int8 MUL kernels use gemmlowp's
    pipeline, unlike ADD).  Fast numerics: round_half_even(product *
    fm) in float32 (the product of two 8-bit differences is exact
    there).  A constant operand broadcasts, also over a stacked window."""
    out_td = ctx.graph.tensor(op.outputs[0])
    x1, x2 = _binary_inputs(ctx, op)
    if f"op{op.index}/fm" in ctx.meta:
        acc = (x1.to(torch.float32) - float(ctx.smeta(op, "zp1"))) * \
            (x2.to(torch.float32) - float(ctx.smeta(op, "zp2")))
        _store_clamped(ctx, op, torch.round(acc * float(ctx.smeta(op, "fm"))))
        return
    acc = (x1.to(torch.int64) - int(ctx.smeta(op, "zp1"))) * \
        (x2.to(torch.int64) - int(ctx.smeta(op, "zp2")))
    out = Q.multiply_by_quantized_multiplier(
        acc, int(ctx.smeta(op, "qm")), int(ctx.smeta(op, "sh")),
        rounding="double",
    ).to(torch.int64) + int(ctx.smeta(op, "zpo"))
    out = out.clamp(int(ctx.smeta(op, "qmin")), int(ctx.smeta(op, "qmax")))
    ctx.set(op.outputs[0], out.to(Q.torch_dtype(out_td.dtype)))


# --------------------------------------------------------------------------
# Pooling
# --------------------------------------------------------------------------

def _pool_geometry(x: torch.Tensor, o) -> Tuple[Tuple[int, int, int, int],
                                                 Tuple[int, int],
                                                 Tuple[int, int]]:
    """(F.pad amounts (left, right, top, bottom), window, strides)."""
    if o["padding"] == "SAME":
        ph = _same_pads(x.shape[1], o["filter_h"], o["stride_h"], 1)
        pw = _same_pads(x.shape[2], o["filter_w"], o["stride_w"], 1)
    else:
        ph, pw = (0, 0), (0, 0)
    return ((pw[0], pw[1], ph[0], ph[1]), (o["filter_h"], o["filter_w"]),
            (o["stride_h"], o["stride_w"]))


def _require_quantized_pool(ctx: LowerCtx, op: OpNode) -> None:
    if not ctx.is_quantized(op.inputs[0]):
        raise LoweringError(
            f"{op.opname} op {op.index}: float pools are not ported to "
            "PyTorch yet"
        )


@register("MAX_POOL_2D")
def _max_pool(ctx: LowerCtx, op: OpNode) -> None:
    """Window max in float32 (exact for 8-bit values); padding never wins
    the max, as the dtype minimum never does in the reference."""
    _require_quantized_pool(ctx, op)
    x = ctx.arr(op.inputs[0])
    td = ctx.graph.tensor(op.outputs[0])
    pads, window, strides = _pool_geometry(x, op.options)
    xf = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), pads,
               value=float("-inf"))
    out = F.max_pool2d(xf, window, strides)
    ctx.set(op.outputs[0],
            out.permute(0, 2, 3, 1).contiguous().to(Q.torch_dtype(td.dtype)))


@register("AVERAGE_POOL_2D")
def _avg_pool(ctx: LowerCtx, op: OpNode) -> None:
    """Window sums and valid-tap counts in float64 (exact), then TFLite's
    rounded integer division (half away from zero) and the fused
    activation clamp."""
    _require_quantized_pool(ctx, op)
    x = ctx.arr(op.inputs[0])
    td = ctx.graph.tensor(op.outputs[0])
    pads, window, strides = _pool_geometry(x, op.options)
    xf = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), pads)
    acc = F.avg_pool2d(xf, window, strides, divisor_override=1)
    ones = F.pad(torch.ones((1, 1, x.shape[1], x.shape[2]),
                            dtype=torch.float64, device=x.device), pads)
    count = F.avg_pool2d(ones, window, strides, divisor_override=1)
    acc = acc.to(torch.int64)
    count = count.to(torch.int64)
    pos = torch.div(acc + count // 2, count, rounding_mode="floor")
    neg = -torch.div(-acc + count // 2, count, rounding_mode="floor")
    out = torch.where(acc >= 0, pos, neg)
    qmin, qmax = Q.quantized_range(td.dtype)
    s, zp = _scalar_qp(td.quant)
    aqmin, aqmax = Q.activation_range(
        op.options.get("activation", "NONE"), s, zp, td.dtype
    )
    out = out.clamp(max(qmin, aqmin), min(qmax, aqmax))
    ctx.set(op.outputs[0],
            out.permute(0, 2, 3, 1).contiguous().to(Q.torch_dtype(td.dtype)))


# --------------------------------------------------------------------------
# RESHAPE
# --------------------------------------------------------------------------

@register("RESHAPE", static_inputs=(1,))
def _reshape(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.arr(op.inputs[0])
    in_td = ctx.graph.tensor(op.inputs[0])
    out_shape = ctx.graph.tensor(op.outputs[0]).shape
    ctx.set(op.outputs[0], x.reshape(_stacked_shape(x, in_td, out_shape)))


# --------------------------------------------------------------------------
# SOFTMAX
# --------------------------------------------------------------------------

def _prepare_softmax(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    in_td = graph.tensor(op.inputs[0])
    out_td = graph.tensor(op.outputs[0])
    if (
        in_td.quant is None or in_td.dtype.kind == "f"
        or out_td.quant is None or out_td.dtype.itemsize != 1
    ):
        raise LoweringError(
            f"SOFTMAX op {op.index}: only the 8-bit quantized softmax is "
            "ported to PyTorch yet"
        )
    xs, _ = _scalar_qp(in_td.quant)
    return {"sm_table": Q.softmax_table(xs, op.options.get("beta", 1.0))}


@register("SOFTMAX", prepare=_prepare_softmax)
def _softmax(ctx: LowerCtx, op: OpNode) -> None:
    """Bit-exact TFLite quantized softmax (exp table + float32 rows
    summed left to right) through its kernel."""
    out_td = ctx.graph.tensor(op.outputs[0])
    os_, ozp = _scalar_qp(out_td.quant)
    ctx.set(op.outputs[0], lut_softmax(
        ctx.arr(op.inputs[0]), ctx.param(op, "sm_table"), os_, ozp,
        out_td.dtype,
    ))


# --------------------------------------------------------------------------
# QUANTIZE, DEQUANTIZE
# --------------------------------------------------------------------------

def _prepare_quantize(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    in_td = graph.tensor(op.inputs[0])
    out_td = graph.tensor(op.outputs[0])
    if out_td.quant is None or out_td.quant.per_channel:
        raise LoweringError(
            f"QUANTIZE op {op.index}: only per-tensor quantized outputs are "
            "ported to PyTorch yet"
        )
    if in_td.quant is None or in_td.dtype.kind == "f":
        return {}
    s_i, _ = _scalar_qp(in_td.quant)
    s_o, _ = _scalar_qp(out_td.quant)
    qm, sh = Q.quantize_multiplier(np.float64(s_i) / np.float64(s_o))
    return {"qm": np.int32(qm), "sh": sh}


@register("QUANTIZE", prepare=_prepare_quantize)
def _quantize_op(ctx: LowerCtx, op: OpNode) -> None:
    """float -> int: round_half_even(x / s) + zp, clamped (band_tpu's
    quantize).  int -> int: TFLite's Requantize, MBQM(q - zp_in) + zp_out
    with ruy's rounding, clamped."""
    g = ctx.graph
    out_td = g.tensor(op.outputs[0])
    s_o, zp_o = _scalar_qp(out_td.quant)
    x = ctx.arr(op.inputs[0])
    if not ctx.is_quantized(op.inputs[0]):
        ctx.set(op.outputs[0], Q.quantize(x, s_o, zp_o, out_td.dtype))
        return
    _, zp_i = _scalar_qp(g.tensor(op.inputs[0]).quant)
    out = Q.multiply_by_quantized_multiplier(
        x.to(torch.int64) - zp_i, int(ctx.smeta(op, "qm")),
        int(ctx.smeta(op, "sh")), rounding="ruy",
    ).to(torch.int64) + zp_o
    qmin, qmax = Q.quantized_range(out_td.dtype)
    ctx.set(op.outputs[0],
            out.clamp(qmin, qmax).to(Q.torch_dtype(out_td.dtype)))


def _prepare_dequantize(graph: Graph, op: OpNode,
                        exact: bool) -> Dict[str, Any]:
    td = graph.tensor(op.inputs[0])
    if (td.quant is None or td.quant.per_channel or td.is_constant
            or td.dtype.kind == "f"):
        raise LoweringError(
            f"DEQUANTIZE op {op.index}: only per-tensor quantized "
            "activations are ported to PyTorch yet"
        )
    return {}


@register("DEQUANTIZE", prepare=_prepare_dequantize)
def _dequantize_op(ctx: LowerCtx, op: OpNode) -> None:
    """(q - zp) * s in float32."""
    s, zp = _scalar_qp(ctx.qp(op.inputs[0]))
    ctx.set(op.outputs[0], Q.dequantize(ctx.arr(op.inputs[0]), s, zp))


# --------------------------------------------------------------------------
# LOGISTIC, TANH, ELU
# --------------------------------------------------------------------------

# Quantized LOGISTIC/TANH/ELU run through TFLite's 256-entry lookup
# tables (activations.cc PopulateLookupTable/EvalUsingLookupTable),
# built from these float transforms (band_tpu/ops/lowerings.py:1782-1786).
_LUT_TRANSFORMS = {
    "LOGISTIC": lambda v: 1.0 / (1.0 + math.exp(-v)),
    "TANH": math.tanh,
    "ELU": lambda v: v if v >= 0.0 else math.expm1(v),
}


def _prepare_unary_lut(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    in_td = graph.tensor(op.inputs[0])
    out_td = graph.tensor(op.outputs[0])
    if op.opname == "ELU" and in_td.quant is None and out_td.quant is None \
            and in_td.dtype == np.float32:
        return {}
    if (
        in_td.quant is None or in_td.dtype.itemsize != 1
        or in_td.dtype.kind == "f"
        or out_td.quant is None or out_td.dtype.itemsize != 1
    ):
        raise LoweringError(
            f"{op.opname} op {op.index}: only the 8-bit quantized form"
            + (" and the float32 ELU" if op.opname == "ELU" else "")
            + " are ported to PyTorch yet"
        )
    xs, xzp = _scalar_qp(in_td.quant)
    os_, ozp = _scalar_qp(out_td.quant)
    return {"lut": Q.activation_lut(_LUT_TRANSFORMS[op.opname], xs, xzp,
                                    os_, ozp, out_td.dtype)}


def _unary_lut(ctx: LowerCtx, op: OpNode) -> None:
    """table[uint8(x)].  The float32 ELU is where(x > 0, x, expm1(x)) with
    expm1 taken in float64 and rounded once to float32: the correctly
    rounded value, the same on the CPU and the card (float32 expm1
    differs by an ulp between libraries; XLA's, in band_tpu, on 11 of
    quant_act_int8's 256 ELU inputs, none of which moves its QUANTIZE)."""
    x = ctx.arr(op.inputs[0])
    if f"op{op.index}/lut" in ctx.params:
        ctx.set(op.outputs[0], Q.apply_lut(x, ctx.param(op, "lut")))
        return
    neg = torch.expm1(torch.clamp(x, max=0.0).to(torch.float64))
    ctx.set(op.outputs[0], torch.where(x > 0, x, neg.to(torch.float32)))


for _name in _LUT_TRANSFORMS:
    register(_name, prepare=_prepare_unary_lut)(_unary_lut)


# --------------------------------------------------------------------------
# MEAN
# --------------------------------------------------------------------------

def _prepare_mean(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """TFLite's integer MEAN (reference_ops::QuantizedMeanOrSum): the
    multiplier of s_in / s_out, shifted left by s = min(floor(log2 n),
    32, 31 + shift) and divided by the count n in integers, applied
    once to sum(x - zp_in).  band_tpu instead quantizes s_in / (s_out
    * n) and subtracts a separately rounded zero-point term, which is
    off by one on a few percent of outputs when n is not a power of two
    (MobileNetV2's 7x7 pool) and on ties otherwise."""
    in_td = graph.tensor(op.inputs[0])
    out_td = graph.tensor(op.outputs[0])
    if in_td.quant is None or in_td.dtype.kind == "f" or out_td.quant is None:
        raise LoweringError(
            f"MEAN op {op.index}: float MEAN is not ported to PyTorch yet"
        )
    axes = tuple(int(v) for v in np.ravel(graph.tensor(op.inputs[1]).data))
    num = 1
    for a in axes:
        num *= in_td.shape[a]
    s_i, zp_i = _scalar_qp(in_td.quant)
    s_o, zp_o = _scalar_qp(out_td.quant)
    qm, sh = Q.quantize_multiplier(float(np.float64(s_i) / np.float64(s_o)))
    s = min(num.bit_length() - 1, 32, 31 + sh)
    return {"qm": np.int32((qm << s) // num), "sh": sh - s,
            "zp_in": zp_i * num, "zp_out": zp_o}


@register("MEAN", prepare=_prepare_mean, static_inputs=(1,))
def _mean(ctx: LowerCtx, op: OpNode) -> None:
    """MBQM(sum(x) - zp_in * n) + zp_out with gemmlowp's double
    rounding, clamped (TFLite exact); the sum is int64."""
    x = ctx.arr(op.inputs[0])
    in_rank = len(ctx.graph.tensor(op.inputs[0]).shape)
    axes = tuple(
        sorted({int(v) % in_rank for v in np.ravel(ctx.static(op.inputs[1]))})
    )
    if 0 in axes:
        raise LoweringError(
            f"MEAN op {op.index}: a mean over the leading (request) axis"
        )
    out_td = ctx.graph.tensor(op.outputs[0])
    keep_dims = len(out_td.shape) == in_rank
    acc = x.to(torch.int64).sum(dim=axes, keepdim=keep_dims)
    out = Q.multiply_by_quantized_multiplier(
        acc - int(ctx.smeta(op, "zp_in")), int(ctx.smeta(op, "qm")),
        int(ctx.smeta(op, "sh")), rounding="double",
    ).to(torch.int64) + int(ctx.smeta(op, "zp_out"))
    qmin, qmax = Q.quantized_range(out_td.dtype)
    ctx.set(op.outputs[0], out.clamp(qmin, qmax).to(Q.torch_dtype(out_td.dtype)))


# --------------------------------------------------------------------------
# Float fallback: dequantize -> float32 -> quantize
# --------------------------------------------------------------------------

def as_float(ctx: LowerCtx, tid: int) -> torch.Tensor:
    """Runtime value of tensor ``tid`` as float32, dequantized if it is
    quantized (band_tpu/ops/lowerings.py:140)."""
    x = ctx.arr(tid)
    if ctx.is_quantized(tid):
        s, zp = _scalar_qp(ctx.qp(tid))
        return Q.dequantize(x, s, zp)
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def store_real(ctx: LowerCtx, tid: int, val: torch.Tensor) -> None:
    """Store a float32 result, quantized if the tensor is quantized
    (band_tpu/ops/lowerings.py:148)."""
    td = ctx.graph.tensor(tid)
    if ctx.is_quantized(tid):
        s, zp = _scalar_qp(td.quant)
        ctx.set(tid, Q.quantize(val, s, zp, td.dtype))
    else:
        ctx.set(tid, val.to(Q.torch_dtype(td.dtype)))


# --------------------------------------------------------------------------
# The request axis: which tensors carry it, and refusals
# --------------------------------------------------------------------------

def _is_shape_value(graph: Graph, tid: int) -> bool:
    """Whether tensor ``tid`` is computed from SHAPE outputs and constants
    alone (the converter's output-shape prelude of a TRANSPOSE_CONV): a
    per-model value with no request axis, which a window does not stack.
    Every other non-constant tensor is per-request data."""
    td = graph.tensor(tid)
    if td.is_constant:
        return True
    prod = next((o for o in graph.ops if tid in o.outputs), None)
    if prod is None:
        return False
    if prod.opname == "SHAPE":
        return True
    return all(_is_shape_value(graph, t) for t in prod.inputs if t >= 0)


def _refuse_request_axis(op: OpNode, what: str) -> LoweringError:
    return LoweringError(
        f"{op.opname} op {op.index}: {what} along the leading (request) axis, "
        "where a window stacks its requests")


def _norm_axis(axis: int, rank: int) -> int:
    return axis + rank if axis < 0 else axis


# --------------------------------------------------------------------------
# SHAPE, STRIDED_SLICE, SLICE, PACK (the converter's prelude to every
# TRANSPOSE_CONV, whose IR output shape is authoritative), TRANSPOSE
# --------------------------------------------------------------------------

def _prepare_shape(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    out_td = graph.tensor(op.outputs[0])
    return {"value": np.asarray(graph.tensor(op.inputs[0]).shape,
                                out_td.dtype)}


@register("SHAPE", prepare=_prepare_shape)
def _shape(ctx: LowerCtx, op: OpNode) -> None:
    """The input's model shape (one request's, as band_tpu's under vmap),
    prepared once: no launch and no copy per run."""
    ctx.set(op.outputs[0], ctx.param(op, "value"))


def _prepare_strided_slice(graph: Graph, op: OpNode,
                           exact: bool) -> Dict[str, Any]:
    """The index as slices and ints (band_tpu/ops/lowerings.py:1516).
    Per-request data keeps its whole leading axis or is refused."""
    o = op.options
    begin = graph.tensor(op.inputs[1]).data.astype(np.int64)
    end = graph.tensor(op.inputs[2]).data.astype(np.int64)
    strides = graph.tensor(op.inputs[3]).data.astype(np.int64)
    if (o.get("ellipsis_mask", 0) or o.get("new_axis_mask", 0)
            or np.any(strides < 0)):
        raise LoweringError(
            f"STRIDED_SLICE op {op.index}: ellipsis and new-axis masks and "
            "negative strides are not ported to PyTorch yet")
    shape = graph.tensor(op.inputs[0]).shape
    data = not _is_shape_value(graph, op.inputs[0])
    index = []
    for d in range(len(begin)):
        b = None if (o.get("begin_mask", 0) >> d) & 1 else int(begin[d])
        e = None if (o.get("end_mask", 0) >> d) & 1 else int(end[d])
        s = int(strides[d])
        shrink = (o.get("shrink_axis_mask", 0) >> d) & 1
        if shrink:
            sel = range(shape[d])[int(begin[d])]
            if d == 0 and data:
                raise _refuse_request_axis(op, "an index")
            index.append(sel)
            continue
        r = range(*slice(b, e, s).indices(int(shape[d])))
        if d == 0 and data:
            if r != range(int(shape[0])):
                raise _refuse_request_axis(op, "a slice")
            index.append(slice(None))
        else:
            index.append(slice(r.start, r.start + len(r) * s, s))
    out = {"index": tuple(index)}
    out.update(_constant_inputs(graph, op))
    return out


@register("STRIDED_SLICE", prepare=_prepare_strided_slice,
          static_inputs=(1, 2, 3))
def _strided_slice(ctx: LowerCtx, op: OpNode) -> None:
    x = _operand(ctx, op, op.inputs[0])
    out = x[ctx.smeta(op, "index")]
    in_td = ctx.graph.tensor(op.inputs[0])
    out_shape = ctx.graph.tensor(op.outputs[0]).shape
    ctx.set(op.outputs[0],
            out.reshape(_stacked_shape(x, in_td, out_shape)).contiguous())


def _prepare_slice(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    b_td, s_td = graph.tensor(op.inputs[1]), graph.tensor(op.inputs[2])
    if not (b_td.is_constant and s_td.is_constant):
        raise LoweringError(
            f"SLICE op {op.index}: a runtime begin or size (the TensorArray "
            "write of WHILE loops) is not ported to PyTorch yet")
    shape = graph.tensor(op.inputs[0]).shape
    data = not _is_shape_value(graph, op.inputs[0])
    index = []
    for d, (b, s) in enumerate(zip(b_td.data, s_td.data)):
        b, s = int(b), int(s)
        e = int(shape[d]) if s == -1 else b + s
        if d == 0 and data:
            if (b, e) != (0, int(shape[0])):
                raise _refuse_request_axis(op, "a slice")
            index.append(slice(None))
        else:
            index.append(slice(b, e))
    out = {"index": tuple(index)}
    out.update(_constant_inputs(graph, op))
    return out


@register("SLICE", prepare=_prepare_slice, static_inputs=(1, 2))
def _slice(ctx: LowerCtx, op: OpNode) -> None:
    x = _operand(ctx, op, op.inputs[0])
    ctx.set(op.outputs[0], x[ctx.smeta(op, "index")].contiguous())


def _prepare_pack(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    rank = len(graph.tensor(op.inputs[0]).shape)
    axis = _norm_axis(op.options.get("axis", 0), rank + 1)
    if axis == 0 and not all(_is_shape_value(graph, t) for t in op.inputs):
        raise _refuse_request_axis(op, "a pack")
    out: Dict[str, Any] = {"axis": axis}
    for tid in op.inputs:
        td = graph.tensor(tid)
        if td.is_constant:
            # constants may carry data in flat (1,) form while the tensor
            # declares scalar (); take the declared shape
            out[f"c{tid}"] = np.asarray(td.data).reshape(td.shape)
    return out


@register("PACK", prepare=_prepare_pack)
def _pack(ctx: LowerCtx, op: OpNode) -> None:
    vals = [_operand(ctx, op, t) for t in op.inputs]
    ctx.set(op.outputs[0], torch.stack(vals, dim=ctx.smeta(op, "axis")))


def _prepare_transpose(graph: Graph, op: OpNode,
                       exact: bool) -> Dict[str, Any]:
    perm = [int(v) for v in graph.tensor(op.inputs[1]).data]
    if perm and perm[0] != 0 and not _is_shape_value(graph, op.inputs[0]):
        raise _refuse_request_axis(op, "a permutation that moves axis 0")
    out: Dict[str, Any] = {"perm": tuple(perm)}
    out.update(_constant_inputs(graph, op))
    return out


@register("TRANSPOSE", prepare=_prepare_transpose, static_inputs=(1,))
def _transpose(ctx: LowerCtx, op: OpNode) -> None:
    """A permute that keeps the request axis in front, materialized (the
    kernels take contiguous operands)."""
    x = _operand(ctx, op, op.inputs[0])
    ctx.set(op.outputs[0], x.permute(ctx.smeta(op, "perm")).contiguous())


# --------------------------------------------------------------------------
# Structural ops: CONCATENATION, PAD, PADV2, MIRROR_PAD, SPLIT, SPLIT_V,
# DEPTH_TO_SPACE, SPACE_TO_DEPTH, RESIZE_NEAREST_NEIGHBOR, RESIZE_BILINEAR
# --------------------------------------------------------------------------

def _prepare_concat(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """Per input whose quantization differs from the output's, TFLite's
    float32 rescale (band_tpu/ops/lowerings.py:1436-1445): scale =
    float32(s_i) * float32(1 / s_o), bias = -zp_i * scale."""
    out_td = graph.tensor(op.outputs[0])
    axis = _norm_axis(op.options.get("axis", 0), len(out_td.shape))
    if axis == 0 and not all(_is_shape_value(graph, t) for t in op.inputs):
        raise _refuse_request_axis(op, "a concatenation")
    out: Dict[str, Any] = {"axis": axis}
    oq = out_td.quant
    for tid in op.inputs:
        td = graph.tensor(tid)
        if (oq is None or td.quant is None or td.dtype.kind == "f"
                or (float(td.quant.scale[0]), int(td.quant.zero_point[0]))
                == (float(oq.scale[0]), int(oq.zero_point[0]))):
            continue
        s_i, zp_i = _scalar_qp(td.quant)
        s_o, _ = _scalar_qp(oq)
        scale = np.float32(np.float32(s_i) * np.float32(1.0 / s_o))
        out[f"scale{tid}"] = float(scale)
        out[f"bias{tid}"] = float(np.float32(-zp_i * scale))
    out.update(_constant_inputs(graph, op))
    return out


@register("CONCATENATION", prepare=_prepare_concat)
def _concat(ctx: LowerCtx, op: OpNode) -> None:
    """Inputs requantized to the output's parameters where they differ
    (round half away from zero of the float32 rescale, clamped), then
    concatenated."""
    out_td = ctx.graph.tensor(op.outputs[0])
    parts = []
    for tid in op.inputs:
        v = _operand(ctx, op, tid)
        if f"op{op.index}/scale{tid}" in ctx.meta:
            val = Q.round_ties_away(
                v.to(torch.float32) * ctx.smeta(op, f"scale{tid}")
                + ctx.smeta(op, f"bias{tid}"))
            _, zp_o = _scalar_qp(out_td.quant)
            qmin, qmax = Q.quantized_range(out_td.dtype)
            v = Q.clamp_rounded(val, zp_o, qmin, qmax, out_td.dtype)
        parts.append(v)
    ctx.set(op.outputs[0], torch.cat(parts, dim=ctx.smeta(op, "axis")))


def _pad_amounts(graph: Graph, op: OpNode):
    pads = [tuple(int(v) for v in row) for row in graph.tensor(op.inputs[1]).data]
    if pads and pads[0] != (0, 0) and not _is_shape_value(graph, op.inputs[0]):
        raise _refuse_request_axis(op, "padding")
    return pads


def _prepare_pad(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """F.pad amounts (last axis first) and the fill: the input's zero
    point (PAD), or the constant of PADV2."""
    pads = _pad_amounts(graph, op)
    td = graph.tensor(op.inputs[0])
    if op.opname == "PADV2":
        fill = np.asarray(graph.tensor(op.inputs[2]).data).reshape(()).item()
    else:
        fill = int(td.quant.zero_point[0]) if td.quant is not None and \
            td.dtype.kind in "iu" else 0
    out = {"pads": tuple(v for row in reversed(pads) for v in row),
           "fill": fill}
    out.update(_constant_inputs(graph, op))
    return out


def _pad(ctx: LowerCtx, op: OpNode) -> None:
    x = _operand(ctx, op, op.inputs[0])
    ctx.set(op.outputs[0], F.pad(x, ctx.smeta(op, "pads"),
                                 value=ctx.smeta(op, "fill")))


register("PAD", prepare=_prepare_pad, static_inputs=(1,))(_pad)
register("PADV2", prepare=_prepare_pad, static_inputs=(1, 2))(_pad)


def _prepare_mirror_pad(graph: Graph, op: OpNode,
                        exact: bool) -> Dict[str, Any]:
    """Per padded axis the source index of every output position
    (numpy's reflect for mode 0, REFLECT; symmetric for mode 1)."""
    pads = _pad_amounts(graph, op)
    shape = graph.tensor(op.inputs[0]).shape
    mode = "reflect" if op.options.get("mode", 0) == 0 else "symmetric"
    out: Dict[str, Any] = {}
    for axis, (b, a) in enumerate(pads):
        if (b, a) != (0, 0):
            out[f"idx{axis}"] = np.pad(np.arange(int(shape[axis])), (b, a),
                                       mode=mode).astype(np.int64)
    out.update(_constant_inputs(graph, op))
    return out


@register("MIRROR_PAD", prepare=_prepare_mirror_pad, static_inputs=(1,))
def _mirror_pad(ctx: LowerCtx, op: OpNode) -> None:
    x = _operand(ctx, op, op.inputs[0])
    for axis in range(x.dim()):
        key = f"op{op.index}/idx{axis}"
        if key in ctx.params:
            x = x.index_select(axis, ctx.params[key])
    ctx.set(op.outputs[0], x)


def _prepare_split(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """SPLIT (axis input 0, equal parts) and SPLIT_V (sizes input 1, one
    of them may be -1, axis input 2): the part sizes along the axis."""
    if op.opname == "SPLIT":
        x_tid, axis_tid = op.inputs[1], op.inputs[0]
    else:
        x_tid, axis_tid = op.inputs[0], op.inputs[2]
    shape = graph.tensor(x_tid).shape
    axis = _norm_axis(int(np.asarray(graph.tensor(axis_tid).data).reshape(())),
                      len(shape))
    if axis == 0 and not _is_shape_value(graph, x_tid):
        raise _refuse_request_axis(op, "a split")
    dim = int(shape[axis])
    if op.opname == "SPLIT":
        sizes = [dim // len(op.outputs)] * len(op.outputs)
    else:
        sizes = [int(v) for v in graph.tensor(op.inputs[1]).data]
        if -1 in sizes:
            sizes[sizes.index(-1)] = dim - (sum(sizes) + 1)
    out = {"axis": axis, "sizes": tuple(sizes), "x": x_tid}
    out.update(_constant_inputs(graph, op))
    return out


def _split(ctx: LowerCtx, op: OpNode) -> None:
    x = _operand(ctx, op, ctx.smeta(op, "x"))
    parts = torch.split(x, list(ctx.smeta(op, "sizes")),
                        dim=ctx.smeta(op, "axis"))
    for tid, part in zip(op.outputs, parts):
        ctx.set(tid, part.contiguous())


register("SPLIT", prepare=_prepare_split, static_inputs=(0,))(_split)
register("SPLIT_V", prepare=_prepare_split, static_inputs=(1, 2))(_split)


@register("DEPTH_TO_SPACE")
def _depth_to_space(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.arr(op.inputs[0])
    b = op.options.get("block_size", 2)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    ctx.set(op.outputs[0], x.reshape(n, h * b, w * b, c // (b * b)))


@register("SPACE_TO_DEPTH")
def _space_to_depth(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.arr(op.inputs[0])
    b = op.options["block_size"]
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    ctx.set(op.outputs[0], x.reshape(n, h // b, w // b, b * b * c))


def _resize_indices(in_size: int, out_size: int, align_corners: bool,
                    half_pixel: bool, nearest: bool) -> np.ndarray:
    """Source coordinate of every output position
    (band_tpu/ops/lowerings.py:2022)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        scale = (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
    if half_pixel:
        return (i + 0.5) * scale - (0.0 if nearest else 0.5)
    return i * scale


def _prepare_resize(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """Index arrays over the input's rows (axis 1) and columns (axis 2):
    the nearest source (floor, or round with align_corners) for
    RESIZE_NEAREST_NEIGHBOR; the two neighbours and the float32 weight of
    the upper one for RESIZE_BILINEAR."""
    shape = graph.tensor(op.inputs[0]).shape
    size = [int(v) for v in graph.tensor(op.inputs[1]).data]
    ac = op.options.get("align_corners", False)
    hp = op.options.get("half_pixel_centers", False)
    nearest = op.opname == "RESIZE_NEAREST_NEIGHBOR"
    out: Dict[str, Any] = {}
    for axis, (n_in, n_out) in zip((1, 2), zip(shape[1:3], size)):
        src = _resize_indices(int(n_in), n_out, ac, hp, nearest)
        if nearest:
            sel = np.round(src) if ac else np.floor(src)
            out[f"idx{axis}"] = np.clip(sel.astype(np.int64), 0, n_in - 1)
            continue
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
        out[f"lo{axis}"] = lo
        out[f"hi{axis}"] = np.clip(lo + 1, 0, n_in - 1)
        frac = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
        out[f"frac{axis}"] = frac.reshape((-1, 1) if axis == 1 else (-1,))
    if not nearest and (graph.tensor(op.inputs[0]).quant is None
                        or graph.tensor(op.outputs[0]).quant is None):
        raise LoweringError(
            f"RESIZE_BILINEAR op {op.index}: the float variant is not "
            "ported to PyTorch yet")
    return out


@register("RESIZE_NEAREST_NEIGHBOR", prepare=_prepare_resize,
          static_inputs=(1,))
def _resize_nearest(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.arr(op.inputs[0])
    x = x.index_select(1, ctx.param(op, "idx1"))
    ctx.set(op.outputs[0], x.index_select(2, ctx.param(op, "idx2")))


@register("RESIZE_BILINEAR", prepare=_prepare_resize, static_inputs=(1,))
def _resize_bilinear(ctx: LowerCtx, op: OpNode) -> None:
    """Float fallback, band_tpu's form: along rows then columns, lo +
    (hi - lo) * frac in float32, then quantized."""
    v = as_float(ctx, op.inputs[0])
    for axis in (1, 2):
        lo = v.index_select(axis, ctx.param(op, f"lo{axis}"))
        hi = v.index_select(axis, ctx.param(op, f"hi{axis}"))
        f = ctx.param(op, f"frac{axis}").unsqueeze(-1)
        v = lo + (hi - lo) * f
    store_real(ctx, op.outputs[0], v)


# --------------------------------------------------------------------------
# RELU, RELU6 (quantized), LEAKY_RELU, PRELU
# --------------------------------------------------------------------------

def _prepare_relu(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    in_td = graph.tensor(op.inputs[0])
    out_td = graph.tensor(op.outputs[0])
    if in_td.quant is None or in_td.dtype.kind == "f":
        return {}
    s_i, zp_i = _scalar_qp(in_td.quant)
    s_o, zp_o = _scalar_qp(out_td.quant)
    qm, sh = Q.quantize_multiplier(np.float64(s_i) / np.float64(s_o))
    qmin, qmax = Q.activation_range(op.opname, s_o, zp_o, out_td.dtype)
    return {"qm": np.int32(qm), "sh": sh, "zp_i": zp_i, "zp_o": zp_o,
            "qmin": qmin, "qmax": qmax}


def _relu(ctx: LowerCtx, op: OpNode) -> None:
    """TFLite's ReluQuantized: MBQM(x - zp_in) with single rounding, plus
    zp_out, clamped to the activation's range.  Float: max(x, 0) or
    clamp(x, 0, 6)."""
    x = ctx.arr(op.inputs[0])
    if f"op{op.index}/qm" not in ctx.meta:
        hi = 6.0 if op.opname == "RELU6" else None
        ctx.set(op.outputs[0], torch.clamp(x, 0.0, hi))
        return
    out_td = ctx.graph.tensor(op.outputs[0])
    val = Q.multiply_by_quantized_multiplier(
        x.to(torch.int64) - int(ctx.smeta(op, "zp_i")),
        int(ctx.smeta(op, "qm")), int(ctx.smeta(op, "sh")),
        rounding="single").to(torch.int64) + int(ctx.smeta(op, "zp_o"))
    out = val.clamp(int(ctx.smeta(op, "qmin")), int(ctx.smeta(op, "qmax")))
    ctx.set(op.outputs[0], out.to(Q.torch_dtype(out_td.dtype)))


register("RELU", prepare=_prepare_relu)(_relu)
register("RELU6", prepare=_prepare_relu)(_relu)


def _alpha_table(x_td: TensorDef, out_td: TensorDef, alpha_q: np.ndarray,
                 alpha_scale: float) -> np.ndarray:
    """TFLite 2.21's int8 PRELU and LEAKY_RELU (activations.cc,
    reference_ops::Prelu / QuantizeLeakyRelu) as a table [len(alpha_q),
    256] over (alpha entry, input byte): x - zp_in >= 0 goes through
    MBQM(x - zp_in, M1) with M1 = s_in / s_out, the rest through
    MBQM((x - zp_in) * alpha_q, M2) with M2 = s_in * s_alpha / s_out (both
    in float32, as TFLite's Prepare computes them), double rounding; plus
    zp_out, clamped to the dtype."""
    f32 = np.float32
    s_i, zp_i = _scalar_qp(x_td.quant)
    s_o, zp_o = _scalar_qp(out_td.quant)
    q1, sh1 = Q.quantize_multiplier(float(f32(s_i) / f32(s_o)))
    q2, sh2 = Q.quantize_multiplier(
        float(f32(f32(s_i) * f32(alpha_scale)) / f32(s_o)))
    info = np.iinfo(x_td.dtype)
    byte = np.arange(256)
    vals = np.where(byte > info.max, byte - 256, byte) if info.min < 0 \
        else byte  # the value whose byte is ``byte``
    xi = torch.from_numpy((vals - zp_i).astype(np.int64))
    a = torch.from_numpy(alpha_q.astype(np.int64).reshape(-1, 1))
    pos = Q.multiply_by_quantized_multiplier(xi, q1, sh1, "double")
    neg = Q.multiply_by_quantized_multiplier(xi * a, q2, sh2, "double")
    out = torch.where(xi >= 0, pos, neg).to(torch.int64) + zp_o
    qmin, qmax = Q.quantized_range(out_td.dtype)
    return out.clamp(qmin, qmax).numpy().astype(out_td.dtype)


def _int8_activation(graph: Graph, op: OpNode) -> bool:
    x_td, out_td = graph.tensor(op.inputs[0]), graph.tensor(op.outputs[0])
    return (x_td.quant is not None and x_td.dtype.kind in "iu"
            and x_td.dtype.itemsize == 1 and out_td.quant is not None
            and out_td.dtype == x_td.dtype)


def _prepare_leaky_relu(graph: Graph, op: OpNode,
                        exact: bool) -> Dict[str, Any]:
    alpha = float(op.options.get("alpha", 0.0))
    if exact and _int8_activation(graph, op):
        table = _alpha_table(graph.tensor(op.inputs[0]),
                             graph.tensor(op.outputs[0]),
                             np.ones(1, np.int64), alpha)
        return {"table": table.reshape(256)}
    return {"alpha": alpha}


@register("LEAKY_RELU", prepare=_prepare_leaky_relu)
def _leaky_relu(ctx: LowerCtx, op: OpNode) -> None:
    """Exact int8/uint8: TFLite's fixed-point kernel as a 256-entry table.
    Otherwise (fast numerics, float) band_tpu's float form: where(x >= 0,
    x, alpha * x) between as_float and store_real."""
    if f"op{op.index}/table" in ctx.params:
        ctx.set(op.outputs[0], Q.apply_lut(ctx.arr(op.inputs[0]),
                                           ctx.param(op, "table")))
        return
    x = as_float(ctx, op.inputs[0])
    store_real(ctx, op.outputs[0],
               torch.where(x >= 0, x, ctx.smeta(op, "alpha") * x))


def _prepare_prelu(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """Exact int8/uint8: TFLite's fixed-point PRELU as a table per channel
    of alpha ([C, 256]; alpha must be a per-tensor quantized constant that
    varies along the last axis at most).  Otherwise band_tpu's float form
    with alpha dequantized in numpy float32 (band_tpu/ops/lowerings.py:
    1859-1871)."""
    a_td = graph.tensor(op.inputs[1])
    x_td = graph.tensor(op.inputs[0])
    if not a_td.is_constant:
        raise LoweringError(
            f"PRELU op {op.index}: a runtime alpha is not ported to "
            "PyTorch yet")
    alpha = a_td.data
    channels = alpha.shape[-1] if alpha.ndim else 1
    if exact and _int8_activation(graph, op):
        if (a_td.quant is None or a_td.quant.per_channel
                or alpha.size != channels or len(x_td.shape) < 1
                or channels not in (1, x_td.shape[-1])):
            raise LoweringError(
                f"PRELU op {op.index}: only a per-tensor quantized alpha of "
                "one value per channel is ported to PyTorch")
        a_s, a_zp = _scalar_qp(a_td.quant)
        table = _alpha_table(x_td, graph.tensor(op.outputs[0]),
                             alpha.reshape(-1).astype(np.int64) - a_zp, a_s)
        return {"table": table.reshape(-1),
                "offsets": (np.arange(channels, dtype=np.int64) * 256)}
    a = alpha.astype(np.float32)
    if a_td.quant is not None and a_td.dtype.kind in "iu":
        a = (alpha.astype(np.float32)
             - a_td.quant.zero_point.astype(np.float32)) * a_td.quant.scale
    return {"alpha": np.asarray(a, np.float32)}


@register("PRELU", prepare=_prepare_prelu)
def _prelu(ctx: LowerCtx, op: OpNode) -> None:
    """Exact: out = table[channel * 256 + byte(x)], one gather.  Fast and
    float: where(x >= 0, x, alpha * x) in float32, quantized."""
    if f"op{op.index}/table" in ctx.params:
        x = ctx.arr(op.inputs[0])
        idx = x.view(torch.uint8).to(torch.int64) + ctx.param(op, "offsets")
        ctx.set(op.outputs[0], ctx.param(op, "table")[idx])
        return
    x = as_float(ctx, op.inputs[0])
    store_real(ctx, op.outputs[0],
               torch.where(x >= 0, x, ctx.param(op, "alpha") * x))


# --------------------------------------------------------------------------
# Float unary table, SQUARED_DIFFERENCE, BATCH_MATMUL (float fallbacks)
# --------------------------------------------------------------------------

def _gelu(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh form, in its order of operations
    (the parser decodes no GELU options)."""
    c = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                * (v + 0.044715 * v ** 3)))
    return v * c


# band_tpu/ops/lowerings.py:1826-1849
_FLOAT_UNARY = {
    "EXP": torch.exp,
    "LOG": torch.log,
    "SQRT": torch.sqrt,
    "RSQRT": torch.rsqrt,
    "SQUARE": torch.square,
    "ABS": torch.abs,
    "NEG": torch.neg,
    "SIN": torch.sin,
    "COS": torch.cos,
    "FLOOR": torch.floor,
    "CEIL": torch.ceil,
    "ROUND": torch.round,
    "GELU": _gelu,
    # jax.nn.hard_swish, x * (relu6(x + 3) / 6), as XLA runs it: the
    # division by a constant becomes a multiply by its reciprocal
    "HARD_SWISH": lambda v: v * (F.relu6(v + 3.0) * (1.0 / 6.0)),
}


def _float_unary(fn):
    def lower(ctx: LowerCtx, op: OpNode) -> None:
        store_real(ctx, op.outputs[0], fn(as_float(ctx, op.inputs[0])))

    return lower


for _name, _fn in _FLOAT_UNARY.items():
    register(_name)(_float_unary(_fn))


@register("SQUARED_DIFFERENCE")
def _squared_difference(ctx: LowerCtx, op: OpNode) -> None:
    a = as_float(ctx, op.inputs[0])
    b = as_float(ctx, op.inputs[1])
    store_real(ctx, op.outputs[0], torch.square(a - b))


@register("BATCH_MATMUL")
def _batch_matmul(ctx: LowerCtx, op: OpNode) -> None:
    """matmul in float32 between as_float and store_real, as band_tpu
    computes it (outside any Pallas kernel).  On the card TF32 must be
    off: it would round the operands to 10-bit mantissas."""
    a = as_float(ctx, op.inputs[0])
    b = as_float(ctx, op.inputs[1])
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise LoweringError(
            f"BATCH_MATMUL op {op.index}: TF32 matmul is on "
            "(torch.backends.cuda.matmul.allow_tf32)")
    store_real(ctx, op.outputs[0], torch.matmul(a, b))


# --------------------------------------------------------------------------
# TRANSPOSE_CONV: the sub-pixel phases as one union convolution on kernel B2
# --------------------------------------------------------------------------

def _tconv_pads(o, in_h, in_w, kh, kw, sh, sw, out_h, out_w):
    """TFLite transpose-conv pad-before: total = (in-1)*s + k - out (SAME)."""
    if o["padding"] == "SAME":
        tp_h = max((in_h - 1) * sh + kh - out_h, 0)
        tp_w = max((in_w - 1) * sw + kw - out_w, 0)
        return tp_h // 2, tp_w // 2
    return 0, 0


def _tconv_phases(k: int, s: int, pb: int, out_size: int):
    """Sub-pixel (phase) decomposition of a 1-D transpose conv
    (band_tpu/ops/lowerings.py:2098).  With cb = k-1-pb, the outputs of
    phase r, o[s*t + r], are a dense VALID convolution of the undilated
    input with the kernel slice w[u0_r::s]:

      o[s*t + r] = sum_a x[t + a + off_r] * w[s*a + u0_r],
      u0_r = (cb - r) mod s,  off_r = (r + u0_r - cb) / s.

    Returns [(u0, ka, off, T)] per phase r: ka taps, T outputs."""
    cb = k - 1 - pb
    out = []
    for r in range(s):
        u0 = (cb - r) % s
        ka = max(-(-(k - u0) // s), 0)
        off = (r + u0 - cb) // s
        T = -(-(out_size - r) // s)
        out.append((u0, ka, off, T))
    return out


def _tconv_window(phases, size: int):
    """The union window of one axis's phases: (lo, taps, pads, crop, T)
    -- the phases' taps span input offsets lo .. lo + taps - 1 (over the
    phases that have taps); the union conv computes T = max T_r outputs,
    reads the input padded by ``pads`` (x_zp, B2's own padding) and its
    output rows from ``crop`` on are the phases' t = 0, 1, ..."""
    live = [(off, ka) for _, ka, off, _ in phases if ka > 0]
    lo = min(off for off, _ in live)
    taps = max(off + ka for off, ka in live) - lo
    T = max(t for *_, t in phases)
    end = lo + T + taps - 1  # one past the last input row the outputs read
    return lo, taps, (max(0, -lo), max(0, end - size)), max(lo, 0), T


def _wrap_int32(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(
        np.int32)


def _prepare_transpose_conv(graph: Graph, op: OpNode,
                            exact: bool) -> Dict[str, Any]:
    """The B2 operands of one union conv of every sub-pixel phase (rh, rw),
    per rounding group.  Its window spans, on each axis, the phases'
    input offsets (_tconv_window); its output channels are (rh, rw, c)
    for the group's channels c.  Each phase's kernel slice w[u0::s] sits
    at its own offset in the window, and every tap a phase does not have
    holds w_zp: (w - w_zp) is 0 there, so the tap adds nothing to conv -
    w_zp * window-sum, in or out of the image (exact under the int32
    wrap).  Phase channels carry the phase's bias (bias - x_zp * sum(w) +
    k * x_zp * w_zp, plus badj: the x_zp and w_zp mass of the taps the
    phase does not compute) and repeat the group's multipliers.  A phase
    with no taps is an all-w_zp slice: its output is its requantized
    bias.

    Rounding (fault C3 in ROADMAP.md): TFLite 2.21 requantizes an int8
    TRANSPOSE_CONV per channel through optimized_ops::Quantize, whose
    8-channel SIMD loop (NEON, or NEON_2_SSE on x86) rounds as ruy does
    and whose scalar tail, channels 8*floor(Oc/8) and up, with
    MultiplyByQuantizedMultiplier's double rounding; its multipliers are
    the per-channel double(s_x) * double(s_w) / double(s_out) even for
    one scale.  So the exact form runs one B2 launch per rounding group.
    band_tpu rounds every channel as ruy; uint8 weights and fast numerics
    follow band_tpu (one group)."""
    w_td = graph.tensor(op.inputs[1])
    x_td = graph.tensor(op.inputs[2])
    out_td = graph.tensor(op.outputs[0])
    if x_td.quant is None or x_td.dtype.kind == "f" or out_td.quant is None:
        raise LoweringError(
            f"TRANSPOSE_CONV op {op.index}: float and hybrid variants are "
            "not ported to PyTorch yet (int8/uint8 only)")
    # rotate 180 degrees and go to HWIO: a VALID conv reproduces the
    # scatter form of TFLite's TransposeConv
    w_hwio = np.transpose(w_td.data[:, ::-1, ::-1, :], (1, 2, 3, 0))
    fake = OpNode(index=op.index, opname=op.opname,
                  inputs=[op.inputs[2], op.inputs[1],
                          op.inputs[3] if len(op.inputs) > 3 else -1],
                  outputs=op.outputs, options=dict(op.options))
    fake.options.setdefault("activation", "NONE")
    kh, kw, ci, oc = w_hwio.shape
    d = _prepare_conv_common(graph, fake, w_td, w_hwio, sum_axes=(0, 1, 2),
                             k_taps=kh * kw * ci, exact=exact)
    groups = [(0, oc, "ruy")]
    if exact and w_td.dtype == np.int8:
        xs, _ = _scalar_qp(x_td.quant)
        os_, _ = _scalar_qp(out_td.quant)
        ws = np.broadcast_to(w_td.quant.scale.astype(np.float64), (oc,))
        d["qm"], d["shift"] = Q.quantize_multipliers(
            np.float64(xs) * ws / np.float64(os_))
        k8 = oc // 8 * 8
        groups = [g for g in ((0, k8, "ruy"), (k8, oc, "double"))
                  if g[1] > g[0]]

    o = op.options
    sh, sw = o["stride_h"], o["stride_w"]
    out_shape = out_td.shape
    if out_shape[1] is None or out_shape[1] < 0:
        out_shape = graph.tensor(op.inputs[0]).data
    out_h, out_w = int(out_shape[1]), int(out_shape[2])
    in_h, in_w = int(x_td.shape[1]), int(x_td.shape[2])
    pb_h, pb_w = _tconv_pads(o, in_h, in_w, kh, kw, sh, sw, out_h, out_w)
    w_i8, xzp, wzp = d.pop("w"), d["x_zp"], d["w_zp"]
    bias = d.pop("bias").astype(np.int64)
    full_sum = w_i8.astype(np.int64).sum(axis=(0, 1, 2))
    phases_h = _tconv_phases(kh, sh, pb_h, out_h)
    phases_w = _tconv_phases(kw, sw, pb_w, out_w)
    lo_h, uh, pads_h, crop_h, t_h = _tconv_window(phases_h, in_h)
    lo_w, uw, pads_w, crop_w, t_w = _tconv_window(phases_w, in_w)
    # [taps h, taps w, ci, phase, oc]: w_zp where a phase has no tap
    wu = np.full((uh, uw, ci, sh * sw, oc), wzp, np.int8)
    pbias = np.zeros((sh * sw, oc), np.int32)
    for rh, (u0h, kah, offh, _) in enumerate(phases_h):
        for rw, (u0w, kaw, offw, _) in enumerate(phases_w):
            wp = w_i8[u0h::sh, u0w::sw]
            taps_p = wp.shape[0] * wp.shape[1] * ci
            badj = (xzp * (full_sum - wp.astype(np.int64).sum(axis=(0, 1, 2)))
                    - wzp * (kh * kw * ci - taps_p) * xzp)
            p = rh * sw + rw
            pbias[p] = _wrap_int32(bias + badj)
            wu[offh - lo_h:offh - lo_h + kah, offw - lo_w:offw - lo_w + kaw,
               :, p] = wp
    wu = wu.reshape(uh * uw * ci, sh * sw, oc)
    epilogue = ("mult",) if "mult" in d else ("qm", "shift")
    for g, (c0, c1, _) in enumerate(groups):
        d[f"w_{g}"] = np.ascontiguousarray(
            wu[:, :, c0:c1].reshape(uh * uw * ci, -1))
        d[f"bias_{g}"] = np.ascontiguousarray(pbias[:, c0:c1].reshape(-1))
        for name in epilogue:
            d[f"{name}_{g}"] = np.tile(
                np.broadcast_to(d[name], (oc,))[c0:c1], sh * sw)
    for name in ("qm", "shift", "mult"):
        d.pop(name, None)
    d.update(groups=tuple(groups), taps=(uh, uw), pads=(pads_h, pads_w),
             crop=(crop_h, crop_w), tiles=(t_h, t_w), out_hw=(out_h, out_w),
             oc=oc)
    return d


@register("TRANSPOSE_CONV", prepare=_prepare_transpose_conv,
          static_inputs=(0,))
def _transpose_conv(ctx: LowerCtx, op: OpNode) -> None:
    """One B2 launch (B2 fast in fast numerics) per rounding group computes
    every phase, requant fused, its window filled with x_zp by B2's own
    padding and w_zp's window sum subtracted by B2.  Its output [n, T_h,
    T_w, (sh, sw, c)] lands in the interleave with one copy: a view
    permuted to [n, T_h, sh, T_w, sw, c].  Where a stride does not divide
    the output size the phases' last rows and columns past it are cut
    (one more copy).  The output-shape input (SHAPE -> STRIDED_SLICE ->
    PACK) is not read: the IR's static shape is authoritative, and the
    request axis is x's leading one."""
    x = _to_int8_domain(ctx.arr(op.inputs[2]))
    dt = Q.torch_dtype(ctx.graph.tensor(op.outputs[0]).dtype)
    n = x.shape[0]
    out_h, out_w = ctx.smeta(op, "out_hw")
    oc = ctx.smeta(op, "oc")
    sh, sw = op.options["stride_h"], op.options["stride_w"]
    uh, uw = ctx.smeta(op, "taps")
    ch, cw = ctx.smeta(op, "crop")
    t_h, t_w = ctx.smeta(op, "tiles")
    full = torch.empty((n, t_h, sh, t_w, sw, oc), dtype=dt, device=x.device)
    fast = f"op{op.index}/mult_0" in ctx.params
    rq = dict(kh=uh, kw=uw, stride=(1, 1), dilation=(1, 1),
              padding=ctx.smeta(op, "pads"),
              x_zp=int(ctx.smeta(op, "x_zp")), w_zp=int(ctx.smeta(op, "w_zp")),
              out_zp=int(ctx.smeta(op, "out_zp")),
              qmin=int(ctx.smeta(op, "qmin")), qmax=int(ctx.smeta(op, "qmax")),
              out_dtype=dt)
    for g, (c0, c1, rounding) in enumerate(ctx.smeta(op, "groups")):
        w, b = ctx.param(op, f"w_{g}"), ctx.param(op, f"bias_{g}")
        if fast:
            u = qconv2d_fast(x, w, b, ctx.param(op, f"mult_{g}"), **rq)
        else:
            u = qconv2d_exact(x, w, b, ctx.param(op, f"qm_{g}"),
                              ctx.param(op, f"shift_{g}"), rounding=rounding,
                              **rq)
        u = u[:, ch:ch + t_h, cw:cw + t_w].unflatten(3, (sh, sw, c1 - c0))
        full[..., c0:c1] = u.permute(0, 1, 3, 2, 4, 5)
    out = full.reshape(n, t_h * sh, t_w * sw, oc)
    if (t_h * sh, t_w * sw) != (out_h, out_w):
        out = out[:, :out_h, :out_w].contiguous()
    ctx.set(op.outputs[0], out)
