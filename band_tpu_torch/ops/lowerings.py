"""PyTorch lowerings of the int8 TFLite ops of the serving path.

Each op is a numpy ``prepare`` (run once per subgraph: weight layout,
zero-point corrections folded into the bias, fixed-point multipliers)
and a lowering that runs on torch tensors.  Every int8 CONV_2D,
DEPTHWISE_CONV_2D and FULLY_CONNECTED goes through a hand-written kernel
(ops/kernels), which on a CPU tensor runs its plain PyTorch version;
quantized SOFTMAX goes through its kernel too.  ADD and MEAN are plain
PyTorch in int64, the pools in floating point (exact for 8-bit values),
RESHAPE a view.

Counterparts: band_tpu/ops/lowerings.py.  The TPU routing gates there
(256-row tiles and M padding, the C<=64 boundary-only depthwise rule,
split and dense-diagonal weights, batch hints, fusion islands) are
lowering choices for the TPU, not semantics, and have no counterpart.

Batches: a window of B requests runs as one call with the requests
stacked on the leading axis, so a tensor whose model shape is
[d0, ...] arrives as [B*d0, ...].  Lowerings keep that axis: shapes
taken from the model are rescaled by ``_stacked_shape``, and no op
reduces over axis 0.

Only the slice's op set is here (the op set of MobileNetV2 and the
tests/data CNNs); float and hybrid variants of these ops raise
LoweringError.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import LoweringError
from ..ir.graph import Graph, OpNode, QuantParams, TensorDef
from . import quant as Q
from .kernels import lut_softmax, qconv2d_exact, qdwconv2d_exact, qmatmul_exact
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


def _requant_args(ctx: LowerCtx, op: OpNode, out_td: TensorDef) -> Dict[str, Any]:
    return dict(
        out_zp=int(ctx.smeta(op, "out_zp")),
        qmin=int(ctx.smeta(op, "qmin")),
        qmax=int(ctx.smeta(op, "qmax")),
        rounding=ctx.smeta(op, "rounding"),
        w_zp=int(ctx.smeta(op, "w_zp")),
        out_dtype=Q.torch_dtype(out_td.dtype),
    )


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
    if not exact:
        raise LoweringError("fast numerics are not ported to PyTorch yet")
    qm, shift = Q.quantize_multipliers(multipliers)
    out["qm"] = qm
    out["shift"] = shift
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
    """1x1 stride-1 unpadded convs are matmuls (kernel B1); every other
    conv runs the implicit-GEMM conv kernel (B2) with its own padding."""
    x = _to_int8_domain(ctx.arr(op.inputs[0]))
    w = ctx.param(op, "w")  # HWIO int8
    out_td = ctx.graph.tensor(op.outputs[0])
    opts = op.options
    kh, kw, ci, oc = w.shape
    ph, pw = _conv_pads(opts, x.shape[1], x.shape[2], kh, kw)
    dil = (opts.get("dilation_h", 1), opts.get("dilation_w", 1))
    strides = (opts["stride_h"], opts["stride_w"])
    rq = _requant_args(ctx, op, out_td)
    epi = (ctx.param(op, "bias"), ctx.param(op, "qm"), ctx.param(op, "shift"))
    if (kh, kw) == (1, 1) and strides == (1, 1) and ph == (0, 0) and pw == (0, 0):
        n, h, w_, _ = x.shape
        out = qmatmul_exact(x.reshape(n * h * w_, ci), w.reshape(ci, oc),
                            *epi, **rq)
        ctx.set(op.outputs[0], out.reshape(n, h, w_, oc))
        return
    out = qconv2d_exact(
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
    """Every int8 depthwise conv runs kernel B3 (any stride, dilation and
    depth multiplier; padded taps read x_zp)."""
    x = _to_int8_domain(ctx.arr(op.inputs[0]))
    w = ctx.param(op, "w")  # HWIO [kh, kw, 1, C*mult] int8
    out_td = ctx.graph.tensor(op.outputs[0])
    opts = op.options
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _conv_pads(opts, x.shape[1], x.shape[2], kh, kw)
    out = qdwconv2d_exact(
        x, w.reshape(kh * kw, w.shape[-1]), ctx.param(op, "bias"),
        ctx.param(op, "qm"), ctx.param(op, "shift"), kh=kh, kw=kw,
        stride=(opts["stride_h"], opts["stride_w"]),
        dilation=(opts.get("dilation_h", 1), opts.get("dilation_w", 1)),
        padding=(ph, pw), x_zp=int(ctx.smeta(op, "x_zp")),
        **_requant_args(ctx, op, out_td),
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
    """Every int8 FC runs kernel B1 on the input's rows."""
    x_raw = ctx.arr(op.inputs[0])
    x = _to_int8_domain(x_raw)
    out_td = ctx.graph.tensor(op.outputs[0])
    out = qmatmul_exact(
        x.reshape(-1, x.shape[-1]), ctx.param(op, "w"), ctx.param(op, "bias"),
        ctx.param(op, "qm"), ctx.param(op, "shift"),
        **_requant_args(ctx, op, out_td),
    )
    in_td = ctx.graph.tensor(op.inputs[0])
    ctx.set(op.outputs[0],
            out.reshape(_stacked_shape(x_raw, in_td, out_td.shape)))


# --------------------------------------------------------------------------
# ADD
# --------------------------------------------------------------------------

def _prepare_addsub(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    t1, t2 = graph.tensor(op.inputs[0]), graph.tensor(op.inputs[1])
    out_td = graph.tensor(op.outputs[0])
    if (t1.quant is None or t1.dtype.kind == "f" or t2.quant is None
            or out_td.quant is None):
        raise LoweringError(
            f"{op.opname} op {op.index}: float variants are not ported to "
            "PyTorch yet"
        )
    if not exact:
        raise LoweringError("fast numerics are not ported to PyTorch yet")
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
    for tid in op.inputs:
        td = graph.tensor(tid)
        if td.is_constant:
            d[f"c{tid}"] = td.data
    return d


def _binary_inputs(ctx: LowerCtx, op: OpNode):
    vals = []
    for tid in op.inputs[:2]:
        key = f"op{op.index}/c{tid}"
        vals.append(ctx.params[key] if key in ctx.params else ctx.arr(tid))
    return vals


@register("ADD", prepare=_prepare_addsub)
def _add(ctx: LowerCtx, op: OpNode) -> None:
    """TFLite's quantized ADD: both inputs rescaled to a common scale
    (x - zp) << 20 through single-rounding MBQM, summed, rescaled to the
    output, all in int64."""
    out_td = ctx.graph.tensor(op.outputs[0])
    x1, x2 = _binary_inputs(ctx, op)
    ls = int(ctx.smeta(op, "left_shift"))
    a1 = x1.to(torch.int64) - int(ctx.smeta(op, "zp1"))
    a2 = x2.to(torch.int64) - int(ctx.smeta(op, "zp2"))
    s1 = Q.multiply_by_quantized_multiplier(
        a1 << ls, int(ctx.smeta(op, "qm1")), int(ctx.smeta(op, "sh1")))
    s2 = Q.multiply_by_quantized_multiplier(
        a2 << ls, int(ctx.smeta(op, "qm2")), int(ctx.smeta(op, "sh2")))
    raw = s1.to(torch.int64) + s2.to(torch.int64)
    out = Q.multiply_by_quantized_multiplier(
        raw, int(ctx.smeta(op, "qmo")), int(ctx.smeta(op, "sho"))
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
