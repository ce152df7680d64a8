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
[d0, ...] is held as [B*d0, ...] (a per-request scalar as [B]);
``LowerCtx.batch`` is B.  Kernel calls and the ops that work on the
trailing axes take that stacked layout as it is.  An op that works along
the model's leading axis (index, slice, split, pack, pad, permute,
concatenate, gather, scatter, reduce, the segment and space/batch ops)
runs per request, as band_tpu's vmap runs it: ``LowerCtx.view`` gives a
per-request tensor as [B, *model shape] with the request axis as a
leading batch dim, the op runs behind it, and ``LowerCtx.set_view``
flattens the result back; a constant broadcasts, or is repeated over the
requests (a view), and where the indices are per request the request
axis is an explicit index.  Tensors computed from constants and SHAPE
alone (``request_free``: the converter's shape prelude) carry no
request axis and run once.

Float32 and dynamic-range (hybrid) models: CONV_2D, DEPTHWISE_CONV_2D
and FULLY_CONNECTED with float activations run F.conv2d and F.linear in
IEEE float32 (``require_ieee_fp32``: a program with such an op is refused
on a card while the TF32 flag that would change it is on), or, with int8
weights, band_tpu's hybrid semantics: each request's input quantized by
its own range at run time (quant.asym_quant_rows), the FC and the 1x1
convs on kernel qmatmul_hybrid, the other convs as float32 convs of the
residuals.  ADD, SUB, MUL, the pools, MEAN, SOFTMAX, RELU, RELU6 and the
structural ops take float tensors as band_tpu does.

The op set is band_tpu's whole registry (119 op types); float and
hybrid TRANSPOSE_CONV raise LoweringError.  The support op set (casts,
comparisons, select, reductions, integer division, index, move,
segment, spectral and 3-D ops) runs as PyTorch ops on the tensor's
device, TOPK_V2 on a packed key that orders ties by index.

Sequences and control flow: the fused UNIDIRECTIONAL_SEQUENCE_LSTM runs
its stacked gates as one input GEMM and a torch.addmm per step (plain
float32 products, as band_tpu's lax.scan, no Pallas).  WHILE and IF run
their subgraphs as child programs prepared with the parent; a WHILE
reads its condition on the host every iteration, so a program holding
one is not capturable into a CUDA graph.  The Keras 3 TensorArray write,
concat(buf[:i], v, buf[i+1:]), is one scatter at a device-side index.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import LoweringError
from ..ir.graph import Graph, OpNode, QuantParams, TensorDef
from . import quant as Q
from .kernels import (lut_softmax, qconv2d_exact, qconv2d_fast,
                      qdwconv2d_exact, qdwconv2d_fast, qmatmul_exact,
                      qmatmul_fast, qmatmul_hybrid)
from .kernels.qmatmul import HYBRID_ACTIVATIONS
from .registry import register


# --------------------------------------------------------------------------
# Lowering context
# --------------------------------------------------------------------------

class LowerCtx:
    """State threaded through one subgraph run."""

    def __init__(self, graph: Graph, params: Dict[str, torch.Tensor],
                 meta: Dict[str, Any], batch: int = 1,
                 free: Optional[FrozenSet[int]] = None):
        self.graph = graph
        self.params = params
        self.meta = meta
        self.env: Dict[int, torch.Tensor] = {}
        # requests stacked on the leading axis of every per-request tensor
        self.batch = batch
        # the tensors that carry no request axis (request_free)
        self.free = request_free(graph) if free is None else free

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

    def stacked(self, shape) -> Tuple[int, ...]:
        """How a per-request tensor of model shape ``shape`` is held: the
        requests' [d0, ...] blocks stacked on the leading axis, [B*d0,
        ...]; a per-request scalar as [B]."""
        shape = tuple(int(s) for s in shape)
        if not shape:
            return (self.batch,)
        return (self.batch * shape[0],) + shape[1:]

    def view(self, tid: int, value: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """The request view of tensor ``tid`` (``value``, or its runtime
        value), no copy: [B, *model shape], the request axis as a leading
        batch dim; a tensor that carries no request axis as [1, *shape],
        one value for every request."""
        x = self.arr(tid) if value is None else value
        shape = tuple(self.graph.tensor(tid).shape)
        if tid in self.free:
            if x.numel() == int(np.prod(shape)):
                x = x.reshape(shape)  # a scalar constant may be held as (1,)
            return x.unsqueeze(0)
        if not shape:
            return x.reshape(self.batch)
        return x.reshape((self.batch, x.shape[0] // self.batch)
                         + tuple(x.shape[1:]))

    def set_view(self, tid: int, v: torch.Tensor) -> None:
        """Store a request view as tensor ``tid``'s held form: stacked, or
        the one value of a tensor that carries no request axis."""
        if tid in self.free:
            self.set(tid, v[0])
        elif not self.graph.tensor(tid).shape:
            self.set(tid, v.reshape(self.batch))
        else:
            self.set(tid, v.flatten(0, 1))


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


def _float_input(graph: Graph, op: OpNode) -> bool:
    """Whether op's activation input is float: a float32 op, or a hybrid
    one where its weights are int8 (band_tpu's test for the float and
    hybrid branches)."""
    x_td = graph.tensor(op.inputs[0])
    return x_td.quant is None or x_td.dtype.kind == "f"


def _hybrid_weights(graph: Graph, op: OpNode) -> bool:
    """A float op with quantized constant weights: dynamic range.  Only
    int8 weights with zero points 0 (TFLite's hybrid kernels) are taken."""
    w_td = graph.tensor(op.inputs[1])
    if w_td.dtype.kind not in "iu" or w_td.quant is None:
        return False
    if w_td.dtype != np.int8 or np.any(w_td.quant.zero_point != 0):
        raise LoweringError(
            f"{op.opname} op {op.index}: hybrid weights must be int8 with "
            "zero point 0")
    return True


def _apply_float_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    """A float32 op's fused activation (band_tpu/ops/lowerings.py:158)."""
    if activation == "NONE":
        return x
    if activation == "RELU":
        return torch.clamp(x, min=0.0)
    if activation == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    if activation == "RELU_N1_TO_1":
        return torch.clamp(x, -1.0, 1.0)
    if activation == "TANH":
        return torch.tanh(x)
    raise LoweringError(f"unsupported activation {activation}")


def _prepared(ctx: LowerCtx, op: OpNode, key: str, ref_key: str, derive):
    """The port's prepared parameter ``key``; for band_tpu's prepared
    parameters (``params_from_jax``), which name the same tensor in
    band_tpu's layout, ``derive`` of its ``ref_key``."""
    k = f"op{op.index}/{key}"
    if k in ctx.params:
        return ctx.params[k]
    return derive(ctx.param(op, ref_key))


def _optional(ctx: LowerCtx, op: OpNode, key: str):
    return ctx.params.get(f"op{op.index}/{key}")


# --------------------------------------------------------------------------
# TF32: every float32 contraction of the port runs in IEEE float32
# --------------------------------------------------------------------------

# The PyTorch flag that would let each kind of float32 contraction round
# its operands to TF32 (10-bit mantissas) on the card.
TF32_CONV = "torch.backends.cudnn.allow_tf32"
TF32_MATMUL = "torch.backends.cuda.matmul.allow_tf32"


def tf32_on(flag: str) -> bool:
    if flag == TF32_CONV:
        return bool(torch.backends.cudnn.allow_tf32)
    return bool(torch.backends.cuda.matmul.allow_tf32)


def tf32_flag(graph: Graph, op: OpNode) -> Optional[str]:
    """The flag that must be off for ``op`` on a card, or None: float and
    hybrid convs other than the hybrid 1x1 ones (cuDNN), float
    FULLY_CONNECTED and BATCH_MATMUL (cuBLAS), CONV_3D (cuDNN).  The
    hybrid GEMMs run the int8 kernel and take no flag; the sequence LSTM
    (cuBLAS, also the float simulation of the int8 one)."""
    if op.opname in ("BATCH_MATMUL", "UNIDIRECTIONAL_SEQUENCE_LSTM"):
        return TF32_MATMUL
    if op.opname == "CONV_3D":
        return TF32_CONV
    if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED") \
            or op.is_custom or not _float_input(graph, op):
        return None
    w_td = graph.tensor(op.inputs[1])
    hybrid = w_td.dtype.kind in "iu" and w_td.quant is not None
    if op.opname == "FULLY_CONNECTED":
        return None if hybrid else TF32_MATMUL
    if hybrid and op.opname == "CONV_2D" and _gemm_conv(graph, op):
        return None
    return TF32_CONV


def require_ieee_fp32(graph: Graph, op_indices) -> None:
    """The port's TF32 rule, applied when a program is built for a card:
    a float32 contraction is refused while the flag that would run it in
    TF32 is on, rather than the flag being changed behind the caller.
    The subgraphs of WHILE and IF are searched too (a loop body's FC)."""
    for oi in op_indices:
        if graph.ops[oi].opname in CONTROL_FLOW:
            for child in child_graphs(graph, graph.ops[oi]):
                require_ieee_fp32(child, range(len(child.ops)))
            continue
        flag = tf32_flag(graph, graph.ops[oi])
        if flag is not None and tf32_on(flag):
            op = graph.ops[oi]
            raise LoweringError(
                f"{op.opname} op {op.index}: TF32 is on ({flag} is True, "
                "which rounds a float32 contraction's operands to 10-bit "
                f"mantissas); the port does not change it: set {flag} = "
                "False")


def _check_tf32(x: torch.Tensor, op: OpNode, flag: str) -> None:
    """The TF32 rule at run time, for a flag turned on after the build."""
    if x.is_cuda and tf32_on(flag):
        raise LoweringError(
            f"{op.opname} op {op.index}: TF32 is on ({flag} is True); a "
            f"float32 contraction runs only in IEEE float32: set {flag} = "
            "False")


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


def _gemm_conv(graph: Graph, op: OpNode) -> bool:
    """1x1 stride-1 convs (unpadded whatever their padding): GEMMs."""
    w = graph.tensor(op.inputs[1]).shape
    o = op.options
    return (int(w[1]), int(w[2])) == (1, 1) and \
        (o["stride_h"], o["stride_w"]) == (1, 1)


def _prepare_float_conv(graph: Graph, op: OpNode, w_ohwi: np.ndarray,
                        gemm: bool) -> Dict[str, Any]:
    """The float and hybrid branches of the conv prepares
    (band_tpu/ops/lowerings.py:433-455, :715-725) with band_tpu's keys
    (``bias``, ``w_scale``) where the layout is the same and new keys where
    the port needs its own: ``w_ohwi`` (float weights) and ``w_q_ohwi``
    (hybrid weights as float32 integers) [O, kh, kw, I], which permute to
    PyTorch's OIHW with channels-last strides and no copy; for a hybrid 1x1
    conv, a GEMM on qmatmul_hybrid, ``w_i8`` [Ci, Oc] int8 and
    ``w_rowsum`` [Oc] int32.  (band_tpu keeps ``w`` and ``w_q`` in HWIO;
    the lowerings derive the port's layouts from them.)"""
    d: Dict[str, Any] = {}
    if len(op.inputs) > 2 and op.inputs[2] >= 0:
        d["bias"] = graph.tensor(op.inputs[2]).data.astype(np.float32)
    if not _hybrid_weights(graph, op):
        d["w_ohwi"] = np.ascontiguousarray(w_ohwi, np.float32)
        return d
    oc = w_ohwi.shape[0]
    scale = graph.tensor(op.inputs[1]).quant.scale.astype(np.float32)
    d["w_scale"] = np.ascontiguousarray(np.broadcast_to(scale, (oc,)))
    if gemm:
        w = np.ascontiguousarray(w_ohwi.reshape(oc, -1).T)  # [Ci, Oc]
        d["w_i8"] = w
        d["w_rowsum"] = w.astype(np.int64).sum(axis=0).astype(np.int32)
    else:
        d["w_q_ohwi"] = np.ascontiguousarray(w_ohwi, np.float32)
    return d


def _prepare_conv2d(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    w_td = graph.tensor(op.inputs[1])
    if _float_input(graph, op):
        return _prepare_float_conv(graph, op, w_td.data, _gemm_conv(graph, op))
    w_hwio = np.transpose(w_td.data, (1, 2, 3, 0))  # OHWI -> HWIO
    kh, kw, ci, _ = w_hwio.shape
    return _prepare_conv_common(
        graph, op, w_td, w_hwio, sum_axes=(0, 1, 2), k_taps=kh * kw * ci,
        exact=exact,
    )


def _hybrid_gemm(q: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                 rowsum: torch.Tensor, zp: Optional[torch.Tensor],
                 scale: torch.Tensor, bias: Optional[torch.Tensor], rows: int,
                 act: str) -> torch.Tensor:
    """One qmatmul_hybrid launch on the float32 integer codes ``q`` (rows
    x K) with RELU or RELU6 fused into its epilogue, any other activation
    after it."""
    kact = act if act in HYBRID_ACTIVATIONS else "NONE"
    out = qmatmul_hybrid(
        q.to(torch.int8), w, w_scale.expand(w.shape[1]).contiguous(), rowsum,
        zp, scale.reshape(-1), bias, rows=rows, activation=kact)
    return out if kact == act else _apply_float_activation(out, act)


def _ohwi(w_hwio: torch.Tensor) -> torch.Tensor:
    """band_tpu's HWIO conv weights (depthwise: [kh, kw, 1, C*m]) as the
    port's [O, kh, kw, I]."""
    return w_hwio.permute(3, 0, 1, 2).contiguous()


def _float_conv(ctx: LowerCtx, op: OpNode, x: torch.Tensor,
                w_ohwi: torch.Tensor, groups: int,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A float32 conv of NHWC ``x`` (band_tpu's lax.conv_general_dilated,
    band_tpu/ops/lowerings.py:591-606, :836-851) as F.conv2d on NCHW
    views of x and of the [O, kh, kw, I] weights (channels-last strides,
    no copy), ``groups`` groups; the result NHWC.  TFLite's SAME padding
    puts the odd pixel after: where before and after differ, F.pad pads
    first, as F.conv2d pads both sides alike."""
    opts = op.options
    kh, kw = w_ohwi.shape[1], w_ohwi.shape[2]
    (pt, pb), (pl, pr) = _conv_pads(opts, x.shape[1], x.shape[2], kh, kw)
    _check_tf32(x, op, TF32_CONV)
    xc = x.permute(0, 3, 1, 2)
    pad = (pt, pl)
    if (pt, pl) != (pb, pr):
        xc, pad = F.pad(xc, (pl, pr, pt, pb)), (0, 0)
    y = F.conv2d(xc, w_ohwi.permute(0, 3, 1, 2), bias,
                 (opts["stride_h"], opts["stride_w"]), pad,
                 (opts.get("dilation_h", 1), opts.get("dilation_w", 1)),
                 groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _float_conv_op(ctx: LowerCtx, op: OpNode, groups: int) -> None:
    """Float and hybrid CONV_2D and DEPTHWISE_CONV_2D.

    Float: one F.conv2d with the bias, then the fused activation.
    Hybrid (dynamic range), band_tpu's semantics: each request's input is
    quantized by its own range (quant.asym_quant_rows).  A 1x1 stride-1
    CONV_2D is a GEMM on qmatmul_hybrid, exact in int32 as TFLite's
    hybrid conv, with the request's zp and scale over its H*W rows and
    bias and RELU/RELU6 in the epilogue.  Every other hybrid conv is a
    float32 conv of the residuals q - zp, zero-padded, as band_tpu runs
    it (exact while the window's sum stays below 2^24: 9 * 255 * 127 for
    a depthwise 3x3), then * (scale * w_scale) + bias."""
    x = ctx.arr(op.inputs[0])
    act = op.options.get("activation", "NONE")
    out_td = ctx.graph.tensor(op.outputs[0])
    bias = _optional(ctx, op, "bias")
    if not _hybrid_weights(ctx.graph, op):
        w = _prepared(ctx, op, "w_ohwi", "w", _ohwi)
        out = _float_conv(ctx, op, x, w, groups, bias)
        ctx.set(op.outputs[0], _apply_float_activation(out, act).to(
            Q.torch_dtype(out_td.dtype)))
        return
    w_scale = ctx.param(op, "w_scale")
    if op.opname == "CONV_2D" and _gemm_conv(ctx.graph, op):
        w = _prepared(ctx, op, "w_i8", "w_q",
                      lambda w: w.reshape(w.shape[2], w.shape[3]).to(
                          torch.int8).contiguous())
        rowsum = _prepared(ctx, op, "w_rowsum", "w_q",
                           lambda w: w.sum(dim=(0, 1, 2)).to(torch.int32))
        n, h, w_, ci = x.shape
        q, zp, scale = Q.asym_quant_rows(x)
        out = _hybrid_gemm(q.reshape(n * h * w_, ci), w, w_scale, rowsum,
                           zp.reshape(-1), scale, bias, h * w_, act)
        ctx.set(op.outputs[0], out.reshape(n, h, w_, w.shape[1]))
        return
    w = _prepared(ctx, op, "w_q_ohwi", "w_q", _ohwi)
    r, scale = Q.hybrid_quant_input(x)
    acc = _float_conv(ctx, op, r, w, groups, None)
    acc = acc * (scale * w_scale)
    if bias is not None:
        acc = acc + bias
    ctx.set(op.outputs[0], _apply_float_activation(acc, act))


@register("CONV_2D", prepare=_prepare_conv2d)
def _conv2d(ctx: LowerCtx, op: OpNode) -> None:
    """1x1 stride-1 unpadded convs are matmuls (kernel B1, or B4 with fast
    numerics); every other conv runs the implicit-GEMM conv kernel (B2,
    or its fast instance) with its own padding.  Float and hybrid convs:
    ``_float_conv_op``."""
    if _float_input(ctx.graph, op):
        _float_conv_op(ctx, op, groups=1)
        return
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
    w_td = graph.tensor(op.inputs[1])
    if _float_input(graph, op):
        # TFLite layout [1, kh, kw, C*m] -> [C*m, kh, kw, 1]
        return _prepare_float_conv(
            graph, op, np.transpose(w_td.data, (3, 1, 2, 0)), gemm=False)
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
    stride, dilation and depth multiplier; padded taps read x_zp).  Float
    and hybrid: ``_float_conv_op`` with one group per input channel
    (output channel c * m + j reads input channel c, as TFLite's depth
    multiplier m)."""
    if _float_input(ctx.graph, op):
        _float_conv_op(ctx, op, groups=int(ctx.arr(op.inputs[0]).shape[-1]))
        return
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

def _runtime_fc_operands(graph: Graph, op: OpNode) -> bool:
    """Whether an FC's weights or bias are runtime values."""
    return graph.tensor(op.inputs[1]).data is None or (
        len(op.inputs) > 2 and op.inputs[2] >= 0
        and not graph.tensor(op.inputs[2]).is_constant)


def _prepare_fc(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """Quantized: B1/B4's operands.  Float and hybrid: band_tpu's keys
    (band_tpu/ops/lowerings.py:998-1026): ``w`` [out, in] float32, or the
    hybrid ``w_q`` [in, out] int8 (B4's layout), ``w_scale`` [out] and
    ``w_rowsum`` [out] (int32 sums over in); ``bias`` float32."""
    w_td = graph.tensor(op.inputs[1])
    if _runtime_fc_operands(graph, op):
        if w_td.dtype.kind != "f" or not _float_input(graph, op):
            raise LoweringError(
                f"FULLY_CONNECTED op {op.index}: runtime int8 weights (a "
                "control-flow subgraph's input) are not ported to PyTorch")
        # runtime float weights or bias (a loop body's or an IF branch's
        # input): read at run time
        return _constant_inputs(graph, op)
    w = w_td.data  # [out, in]
    if _float_input(graph, op):
        if _hybrid_weights(graph, op):
            scale = w_td.quant.scale.astype(np.float32)
            d: Dict[str, Any] = {
                "w_q": np.ascontiguousarray(w.T.astype(np.int8)),
                "w_scale": np.ascontiguousarray(
                    np.broadcast_to(scale, (w.shape[0],))),
                "w_rowsum": w.astype(np.int64).sum(axis=1).astype(np.int32),
            }
        else:
            d = {"w": np.ascontiguousarray(w, np.float32)}
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            b_td = graph.tensor(op.inputs[2])
            if b_td.is_constant:
                d["bias"] = b_td.data.astype(np.float32)
        return d
    return _prepare_conv_common(
        graph, op, w_td, np.transpose(w, (1, 0)), sum_axes=(0,),
        k_taps=w.shape[1], exact=exact,
    )


def _hybrid_fc(ctx: LowerCtx, op: OpNode, x2: torch.Tensor,
               act: str) -> torch.Tensor:
    """Dynamic-range FC (band_tpu/ops/lowerings.py:971-995, TFLite's
    EvalHybrid): each row of ``x2`` quantized by its own range, symmetric
    or (``asymmetric_quantize_inputs``) asymmetric, then one qmatmul_hybrid
    launch with bias and RELU/RELU6 in its epilogue."""
    if op.options.get("asymmetric_quantize_inputs", False):
        q, zp, scale = Q.asym_quant_rows(x2)
        zp = zp.reshape(-1)
    else:
        (q, scale), zp = Q.sym_quant_rows(x2), None
    return _hybrid_gemm(q, ctx.param(op, "w_q"), ctx.param(op, "w_scale"),
                        ctx.param(op, "w_rowsum"), zp, scale,
                        _optional(ctx, op, "bias"), 1, act)


def _runtime_fc(ctx: LowerCtx, op: OpNode, act: str) -> None:
    """A float FC whose weights (or bias) are runtime values, per request:
    F.linear where the weights carry no request axis, a batched product
    where each request has its own; the bias after the product, as
    band_tpu adds it (band_tpu/ops/lowerings.py:1039-1054)."""
    xv = _lv(ctx, op, op.inputs[0])
    xv = xv.reshape(xv.shape[0], -1, xv.shape[-1]).to(torch.float32)
    wv = _lv(ctx, op, op.inputs[1]).to(torch.float32)
    _check_tf32(xv, op, TF32_MATMUL)
    if wv.shape[0] == 1:
        acc = F.linear(xv, wv[0])
    else:
        acc = torch.matmul(xv, wv.transpose(1, 2))
    if len(op.inputs) > 2 and op.inputs[2] >= 0:
        acc = acc + _lv(ctx, op, op.inputs[2]).to(torch.float32).unsqueeze(1)
    out_shape = tuple(ctx.graph.tensor(op.outputs[0]).shape)
    out = _apply_float_activation(acc, act)
    _put(ctx, op, out.reshape((out.shape[0],) + out_shape))


@register("FULLY_CONNECTED", prepare=_prepare_fc)
def _fully_connected(ctx: LowerCtx, op: OpNode) -> None:
    """Every int8 FC runs kernel B1 (B4 with fast numerics) on the
    input's rows.  Float: x . w^T + bias in float32 (F.linear; cuBLAS with
    TF32 refused), then the fused activation; runtime weights:
    ``_runtime_fc``.  Hybrid: ``_hybrid_fc``."""
    if _runtime_fc_operands(ctx.graph, op):
        _runtime_fc(ctx, op, op.options.get("activation", "NONE"))
        return
    if _float_input(ctx.graph, op):
        x_raw = ctx.arr(op.inputs[0])
        x2 = x_raw.reshape(-1, x_raw.shape[-1])
        act = op.options.get("activation", "NONE")
        out_td = ctx.graph.tensor(op.outputs[0])
        if _hybrid_weights(ctx.graph, op):
            out = _hybrid_fc(ctx, op, x2, act)
        else:
            _check_tf32(x2, op, TF32_MATMUL)
            out = _apply_float_activation(F.linear(
                x2, ctx.param(op, "w"), _optional(ctx, op, "bias")), act)
        ctx.set(op.outputs[0], out.reshape(
            _stacked_width(ctx, out_td, out.shape[-1])).to(
                Q.torch_dtype(out_td.dtype)))
        return
    x_raw = ctx.arr(op.inputs[0])
    x = _to_int8_domain(x_raw)
    out_td = ctx.graph.tensor(op.outputs[0])
    fast, epi, rq = _requant(ctx, op, out_td)
    out = (qmatmul_fast if fast else qmatmul_exact)(
        x.reshape(-1, x.shape[-1]), ctx.param(op, "w"), *epi, **rq)
    ctx.set(op.outputs[0], out.reshape(
        _stacked_width(ctx, out_td, out.shape[-1])))


def _stacked_width(ctx: LowerCtx, td: TensorDef, width: int):
    """``ctx.stacked`` of ``td``'s shape with ``width`` on its last axis:
    the units come from the weights, so that a mesh's shard of the op
    (output channels split, parallel/mesh.py) stores its slice."""
    shape = [int(s) for s in td.shape]
    shape[-1] = int(width)
    return ctx.stacked(shape)


# --------------------------------------------------------------------------
# ADD, SUB, MUL
# --------------------------------------------------------------------------

def _quantized_binary(graph: Graph, op: OpNode) -> bool:
    """Whether ADD, SUB or MUL takes the quantized form (else band_tpu's
    plain one: float32, or int32 for an integer ADD or SUB)."""
    t1, t2 = graph.tensor(op.inputs[0]), graph.tensor(op.inputs[1])
    out_td = graph.tensor(op.outputs[0])
    return not (t1.quant is None or t1.dtype.kind == "f" or t2.quant is None
                or out_td.quant is None)


def _constant_inputs(graph: Graph, op: OpNode) -> Dict[str, Any]:
    return {f"c{tid}": graph.tensor(tid).data for tid in op.inputs
            if graph.tensor(tid).is_constant}


def _prepare_addsub(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    if not _quantized_binary(graph, op):
        return _constant_inputs(graph, op)
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
    """The two inputs of an elementwise op as they broadcast per request:
    request views at the output's rank."""
    rank = len(ctx.graph.tensor(op.outputs[0]).shape)
    return [_lv(ctx, op, tid, rank) for tid in op.inputs[:2]]


def _store_clamped(ctx: LowerCtx, op: OpNode, r: torch.Tensor) -> None:
    """Output = clamp(r + zpo, qmin, qmax) of float32 integers ``r``."""
    out_td = ctx.graph.tensor(op.outputs[0])
    _put(ctx, op, Q.clamp_rounded(
        r, int(ctx.smeta(op, "zpo")), int(ctx.smeta(op, "qmin")),
        int(ctx.smeta(op, "qmax")), out_td.dtype))


def _addsub(ctx: LowerCtx, op: OpNode, sign: int) -> None:
    """TFLite's quantized ADD/SUB: both inputs rescaled to a common scale
    (x - zp) << 20 through single-rounding MBQM, summed (or subtracted),
    rescaled to the output, all in int64.  Fast numerics: round_half_even
    ((x1 - zp1) * f1 + sign * (x2 - zp2) * f2) + zpo in float32, band_tpu's
    form (every product and the sum rounded once, no FMA; the
    differences of 8-bit values are exact in float32).  Float: x1 +/- x2
    in float32 with the fused activation (band_tpu/ops/lowerings.py:
    1151-1162); an integer output adds in its own type."""
    out_td = ctx.graph.tensor(op.outputs[0])
    x1, x2 = _binary_inputs(ctx, op)
    if f"op{op.index}/zp1" not in ctx.meta:
        if out_td.dtype.kind != "f":
            out = x1 + x2 if sign > 0 else x1 - x2
        else:
            x1, x2 = x1.to(torch.float32), x2.to(torch.float32)
            out = _apply_float_activation(
                x1 + x2 if sign > 0 else x1 - x2,
                op.options.get("activation", "NONE"))
        _put(ctx, op, out)
        return
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
    _put(ctx, op, out)


@register("ADD", prepare=_prepare_addsub)
def _add(ctx: LowerCtx, op: OpNode) -> None:
    _addsub(ctx, op, +1)


@register("SUB", prepare=_prepare_addsub)
def _sub(ctx: LowerCtx, op: OpNode) -> None:
    _addsub(ctx, op, -1)


def _prepare_mul(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    if not _quantized_binary(graph, op):
        return _constant_inputs(graph, op)
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
    there).  A constant operand broadcasts, also over a stacked window.
    Float: x1 * x2 in float32 with the fused activation, stored as the
    output's type (band_tpu/ops/lowerings.py:1247)."""
    out_td = ctx.graph.tensor(op.outputs[0])
    x1, x2 = _binary_inputs(ctx, op)
    if f"op{op.index}/qm" not in ctx.meta:
        store_real(ctx, op.outputs[0], _apply_float_activation(
            x1.to(torch.float32) * x2.to(torch.float32),
            op.options.get("activation", "NONE")), view=True)
        return
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
    _put(ctx, op, out)


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


@register("MAX_POOL_2D")
def _max_pool(ctx: LowerCtx, op: OpNode) -> None:
    """Window max in float32 (exact for 8-bit values); padding never wins
    the max, as the dtype minimum never does in the reference.  A float
    output takes the fused activation (band_tpu/ops/lowerings.py:1310)."""
    x = ctx.arr(op.inputs[0])
    td = ctx.graph.tensor(op.outputs[0])
    pads, window, strides = _pool_geometry(x, op.options)
    xf = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), pads,
               value=float("-inf"))
    out = F.max_pool2d(xf, window, strides).permute(0, 2, 3, 1)
    if td.dtype.kind == "f":
        out = _apply_float_activation(out, op.options.get("activation",
                                                          "NONE"))
    ctx.set(op.outputs[0], out.contiguous().to(Q.torch_dtype(td.dtype)))


@register("AVERAGE_POOL_2D")
def _avg_pool(ctx: LowerCtx, op: OpNode) -> None:
    """Window sums and valid-tap counts in float64 (exact), then TFLite's
    rounded integer division (half away from zero) and the fused
    activation clamp.  Float: the float32 window sum over the count of
    in-bounds taps, then the fused activation (band_tpu/ops/
    lowerings.py:1341-1348)."""
    x = ctx.arr(op.inputs[0])
    td = ctx.graph.tensor(op.outputs[0])
    pads, window, strides = _pool_geometry(x, op.options)
    if not ctx.is_quantized(op.inputs[0]):
        xf = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), pads)
        acc = F.avg_pool2d(xf, window, strides, divisor_override=1)
        ones = F.pad(torch.ones((1, 1, x.shape[1], x.shape[2]),
                                dtype=torch.float32, device=x.device), pads)
        count = F.avg_pool2d(ones, window, strides, divisor_override=1)
        out = _apply_float_activation(
            (acc / count).permute(0, 2, 3, 1),
            op.options.get("activation", "NONE"))
        ctx.set(op.outputs[0], out.contiguous().to(Q.torch_dtype(td.dtype)))
        return
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
    x = ctx.view(op.inputs[0])
    out_shape = tuple(int(v) for v in ctx.graph.tensor(op.outputs[0]).shape)
    ctx.set_view(op.outputs[0], x.reshape((x.shape[0],) + out_shape))


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
        return {}
    xs, _ = _scalar_qp(in_td.quant)
    return {"sm_table": Q.softmax_table(xs, op.options.get("beta", 1.0))}


@register("SOFTMAX", prepare=_prepare_softmax)
def _softmax(ctx: LowerCtx, op: OpNode) -> None:
    """Bit-exact TFLite quantized softmax (exp table + float32 rows
    summed left to right) through its kernel.  Otherwise band_tpu's float
    form (band_tpu/ops/lowerings.py:1899-1900): softmax(beta * x) over
    the last axis in float32, between as_float and store_real."""
    if f"op{op.index}/sm_table" not in ctx.params:
        x = as_float(ctx, op.inputs[0])
        beta = float(op.options.get("beta", 1.0))
        store_real(ctx, op.outputs[0], torch.softmax(beta * x, dim=-1))
        return
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
    if in_td.quant is None and out_td.quant is None \
            and in_td.dtype == np.float32:
        return {}
    if (
        in_td.quant is None or in_td.dtype.itemsize != 1
        or in_td.dtype.kind == "f"
        or out_td.quant is None or out_td.dtype.itemsize != 1
    ):
        raise LoweringError(
            f"{op.opname} op {op.index}: only the 8-bit quantized and the "
            "float32 forms are ported to PyTorch")
    xs, xzp = _scalar_qp(in_td.quant)
    os_, ozp = _scalar_qp(out_td.quant)
    return {"lut": Q.activation_lut(_LUT_TRANSFORMS[op.opname], xs, xzp,
                                    os_, ozp, out_td.dtype)}


def _unary_lut(ctx: LowerCtx, op: OpNode) -> None:
    """table[uint8(x)].  The float32 LOGISTIC and TANH are torch.sigmoid
    and torch.tanh (band_tpu's jax.nn.sigmoid and jnp.tanh).  The float32
    ELU is where(x > 0, x, expm1(x)) with expm1 taken in float64 and
    rounded once to float32: the correctly rounded value, the same on the
    CPU and the card (float32 expm1 differs by an ulp between libraries;
    XLA's, in band_tpu, on 11 of quant_act_int8's 256 ELU inputs, none of
    which moves its QUANTIZE)."""
    x = ctx.arr(op.inputs[0])
    if f"op{op.index}/lut" in ctx.params:
        ctx.set(op.outputs[0], Q.apply_lut(x, ctx.param(op, "lut")))
        return
    if op.opname != "ELU":
        fn = torch.sigmoid if op.opname == "LOGISTIC" else torch.tanh
        ctx.set(op.outputs[0], fn(x))
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
        return {}
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
    rounding, clamped (TFLite exact); the sum is int64.  Float: the float32
    mean between as_float and store_real (band_tpu/ops/lowerings.py:
    1999-2000).  Per request: the model's axes behind the request axis."""
    x = ctx.view(op.inputs[0])
    in_rank = x.dim() - 1
    # the model's axes behind the request axis
    axes = tuple(sorted(
        {int(v) % in_rank + 1 for v in np.ravel(ctx.static(op.inputs[1]))}))
    out_td = ctx.graph.tensor(op.outputs[0])
    keep_dims = len(out_td.shape) == in_rank
    if f"op{op.index}/qm" not in ctx.meta:
        store_real(ctx, op.outputs[0], real(ctx, op.inputs[0], x).mean(
            dim=axes, keepdim=keep_dims), view=True)
        return
    acc = x.to(torch.int64).sum(dim=axes, keepdim=keep_dims)
    out = Q.multiply_by_quantized_multiplier(
        acc - int(ctx.smeta(op, "zp_in")), int(ctx.smeta(op, "qm")),
        int(ctx.smeta(op, "sh")), rounding="double",
    ).to(torch.int64) + int(ctx.smeta(op, "zp_out"))
    qmin, qmax = Q.quantized_range(out_td.dtype)
    ctx.set_view(op.outputs[0],
                 out.clamp(qmin, qmax).to(Q.torch_dtype(out_td.dtype)))


# --------------------------------------------------------------------------
# Float fallback: dequantize -> float32 -> quantize
# --------------------------------------------------------------------------

def real(ctx: LowerCtx, tid: int, x: torch.Tensor) -> torch.Tensor:
    """``x``, a value of tensor ``tid`` (in any layout), as float32,
    dequantized if the tensor is quantized."""
    if ctx.is_quantized(tid):
        s, zp = _scalar_qp(ctx.qp(tid))
        return Q.dequantize(x, s, zp)
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def as_float(ctx: LowerCtx, tid: int) -> torch.Tensor:
    """Runtime value of tensor ``tid`` as float32, dequantized if it is
    quantized (band_tpu/ops/lowerings.py:140)."""
    return real(ctx, tid, ctx.arr(tid))


def store_real(ctx: LowerCtx, tid: int, val: torch.Tensor,
               view: bool = False) -> None:
    """Store a float32 result, quantized if the tensor is quantized
    (band_tpu/ops/lowerings.py:148); ``view``: ``val`` is a request
    view."""
    td = ctx.graph.tensor(tid)
    if ctx.is_quantized(tid):
        s, zp = _scalar_qp(td.quant)
        val = Q.quantize(val, s, zp, td.dtype)
    else:
        val = val.to(Q.torch_dtype(td.dtype))
    if view:
        ctx.set_view(tid, val)
    else:
        ctx.set(tid, val)


# --------------------------------------------------------------------------
# The request axis: which tensors carry it, and how an op reaches it
# --------------------------------------------------------------------------

def request_free(graph: Graph, inputs=()) -> FrozenSet[int]:
    """The tensors that carry no request axis: constants, SHAPE and RANK
    outputs and whatever is computed from those alone (the converter's
    output-shape prelude of a TRANSPOSE_CONV, a loop counter): per-model
    values, which a window does not stack.  ``inputs``: a subgraph's
    inputs that carry none (a WHILE's or IF's operands).  The outputs of
    WHILE and IF follow their subgraphs (``control_free``).  Every other
    tensor is per-request data."""
    free = {td.index for td in graph.tensors if td.is_constant}
    free.update(inputs)
    for op in graph.ops:
        if op.opname in CONTROL_FLOW:
            flags, _ = control_free(graph, op, free)
            free.update(t for t, f in zip(op.outputs, flags) if f)
        elif op.opname in ("SHAPE", "RANK") or all(
                t in free for t in op.inputs if t >= 0):
            free.update(op.outputs)
    return frozenset(free)


def _norm_axis(axis: int, rank: int) -> int:
    return axis + rank if axis < 0 else axis


def _lv(ctx: LowerCtx, op: OpNode, tid: int, rank: Optional[int] = None,
        expand: bool = False) -> torch.Tensor:
    """Input ``tid`` of ``op`` in its request view (its prepared constant
    or its runtime value), with singleton dims after the request axis up
    to ``rank`` model dims, so that inputs of different ranks broadcast
    per request; with ``expand`` one that carries no request axis
    repeated over the requests (a view, no copy)."""
    v = ctx.view(tid, _operand(ctx, op, tid))
    if rank is not None and v.dim() - 1 < rank:
        v = v.reshape((v.shape[0],) + (1,) * (rank + 1 - v.dim())
                      + tuple(v.shape[1:]))
    if expand:
        v = v.expand((ctx.batch,) + tuple(v.shape[1:]))
    return v


def _put(ctx: LowerCtx, op: OpNode, v: torch.Tensor, index: int = 0) -> None:
    """Store the request view ``v`` as output ``index`` of ``op``, as the
    output's dtype."""
    tid = op.outputs[index]
    ctx.set_view(tid, v.to(Q.torch_dtype(ctx.graph.tensor(tid).dtype)))


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


def _index_op(ctx: LowerCtx, op: OpNode) -> None:
    """STRIDED_SLICE and SLICE: the prepared model index behind the
    request axis (band_tpu's under vmap)."""
    out = _lv(ctx, op, op.inputs[0])[(slice(None),) + ctx.smeta(op, "index")]
    ctx.set_view(op.outputs[0], out.contiguous())


def _prepare_strided_slice(graph: Graph, op: OpNode,
                           exact: bool) -> Dict[str, Any]:
    """The index as slices and ints (band_tpu/ops/lowerings.py:1516)."""
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
    index = []
    for d in range(len(begin)):
        if (o.get("shrink_axis_mask", 0) >> d) & 1:
            index.append(range(shape[d])[int(begin[d])])
            continue
        b = None if (o.get("begin_mask", 0) >> d) & 1 else int(begin[d])
        e = None if (o.get("end_mask", 0) >> d) & 1 else int(end[d])
        s = int(strides[d])
        r = range(*slice(b, e, s).indices(int(shape[d])))
        index.append(slice(r.start, r.start + len(r) * s, s))
    out = {"index": tuple(index)}
    out.update(_constant_inputs(graph, op))
    return out


register("STRIDED_SLICE", prepare=_prepare_strided_slice,
         static_inputs=(1, 2, 3))(_index_op)


def _prepare_slice(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """A static slice: its index.  A runtime begin with a static size
    (none -1): the ``sizes``.  Any other runtime begin or size: nothing
    (the lowering parks a ``_DynSlice``)."""
    b_td, s_td = graph.tensor(op.inputs[1]), graph.tensor(op.inputs[2])
    if not (b_td.is_constant and s_td.is_constant):
        out: Dict[str, Any] = {"dynamic": True}
        if s_td.is_constant and -1 not in [int(v) for v in s_td.data]:
            out["sizes"] = tuple(int(v) for v in s_td.data)
        out.update(_constant_inputs(graph, op))
        return out
    shape = graph.tensor(op.inputs[0]).shape
    index = []
    for d, (b, s) in enumerate(zip(b_td.data, s_td.data)):
        b, s = int(b), int(s)
        index.append(slice(b, int(shape[d]) if s == -1 else b + s))
    out = {"index": tuple(index)}
    out.update(_constant_inputs(graph, op))
    return out


class _DynSlice:
    """A SLICE whose size is a runtime value (band_tpu/ops/lowerings.py:
    1387): the only place TFLite makes one is the TensorArray write of a
    Keras 3 loop body, concat(buf[:i], v, buf[i+1:]), which CONCATENATION
    rewrites into one scatter at a device-side index.  Any other use
    raises band_tpu's error."""

    def __init__(self, src_tid, src, begin_tid, begin, sizes_tid, sizes):
        self.src_tid, self.src = src_tid, src
        self.begin_tid, self.begin = begin_tid, begin
        self.sizes_tid, self.sizes = sizes_tid, sizes

    def fail(self):
        raise LoweringError(
            "SLICE: dynamic sizes are not expressible outside the "
            "TensorArray-write pattern (concat(buf[:i], v, buf[i+1:])); "
            "convert growing-loop models through the fused kernel path "
            "(e.g. UNIDIRECTIONAL_SEQUENCE_LSTM)")

    def __getattr__(self, name):
        self.fail()


@register("SLICE", prepare=_prepare_slice, static_inputs=(1, 2))
def _slice(ctx: LowerCtx, op: OpNode) -> None:
    """A static slice: ``_index_op``.  A runtime begin with a static size:
    per model axis that the slice cuts, the begin clamped into range (as
    lax.dynamic_slice clamps it) and the rows taken with index_select,
    or, where each request has its own begin, gather; no host sync.  A
    runtime size: a ``_DynSlice`` for CONCATENATION."""
    if f"op{op.index}/dynamic" not in ctx.meta:
        _index_op(ctx, op)
        return
    x_tid, b_tid, s_tid = op.inputs[:3]
    sizes = ctx.meta.get(f"op{op.index}/sizes")
    if sizes is None:
        ctx.set(op.outputs[0], _DynSlice(
            x_tid, _operand(ctx, op, x_tid), b_tid, _operand(ctx, op, b_tid),
            s_tid, _operand(ctx, op, s_tid)))
        return
    shape = ctx.graph.tensor(x_tid).shape
    x = _lv(ctx, op, x_tid)
    begin = _lv(ctx, op, b_tid).to(torch.int64)
    if begin.shape[0] > x.shape[0]:
        x = x.expand((begin.shape[0],) + tuple(x.shape[1:]))
    for d, size in enumerate(sizes):
        if size == int(shape[d]):
            continue
        pos = torch.arange(size, device=x.device)
        start = begin[:, d].clamp(0, int(shape[d]) - size)
        if begin.shape[0] == 1:
            x = x.index_select(d + 1, start + pos)
            continue
        idx_shape = [1] * x.dim()
        idx_shape[0], idx_shape[d + 1] = x.shape[0], size
        idx = (start.unsqueeze(1) + pos).reshape(idx_shape)
        out_shape = list(x.shape)
        out_shape[d + 1] = size
        x = torch.gather(x, d + 1, idx.expand(out_shape))
    ctx.set_view(op.outputs[0], x.contiguous())


def _prepare_pack(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    rank = len(graph.tensor(op.inputs[0]).shape)
    out: Dict[str, Any] = {"axis": _norm_axis(op.options.get("axis", 0),
                                              rank + 1)}
    for tid in op.inputs:
        td = graph.tensor(tid)
        if td.is_constant:
            # constants may carry data in flat (1,) form while the tensor
            # declares scalar (); take the declared shape
            out[f"c{tid}"] = np.asarray(td.data).reshape(td.shape)
    return out


@register("PACK", prepare=_prepare_pack)
def _pack(ctx: LowerCtx, op: OpNode) -> None:
    """Per request, a constant input repeated over the requests."""
    vals = [_lv(ctx, op, t, expand=True) for t in op.inputs]
    ctx.set_view(op.outputs[0],
                 torch.stack(vals, dim=ctx.smeta(op, "axis") + 1))


def _prepare_transpose(graph: Graph, op: OpNode,
                       exact: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {"perm": tuple(
        int(v) for v in graph.tensor(op.inputs[1]).data)}
    out.update(_constant_inputs(graph, op))
    return out


@register("TRANSPOSE", prepare=_prepare_transpose, static_inputs=(1,))
def _transpose(ctx: LowerCtx, op: OpNode) -> None:
    """The model permutation behind the request axis, materialized (the
    kernels take contiguous operands)."""
    v = _lv(ctx, op, op.inputs[0]).permute(
        (0,) + tuple(p + 1 for p in ctx.smeta(op, "perm")))
    ctx.set_view(op.outputs[0], v.contiguous())


# --------------------------------------------------------------------------
# Structural ops: CONCATENATION, PAD, PADV2, MIRROR_PAD, SPLIT, SPLIT_V,
# DEPTH_TO_SPACE, SPACE_TO_DEPTH, RESIZE_NEAREST_NEIGHBOR, RESIZE_BILINEAR
# --------------------------------------------------------------------------

def _prepare_concat(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """Per input whose quantization differs from the output's, TFLite's
    float32 rescale (band_tpu/ops/lowerings.py:1436-1445): scale =
    float32(s_i) * float32(1 / s_o), bias = -zp_i * scale."""
    out_td = graph.tensor(op.outputs[0])
    out: Dict[str, Any] = {"axis": _norm_axis(op.options.get("axis", 0),
                                              len(out_td.shape))}
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
    concatenated, per request (a constant input repeated over the
    requests)."""
    out_td = ctx.graph.tensor(op.outputs[0])
    if any(isinstance(ctx.env.get(t), _DynSlice) for t in op.inputs):
        _tensorarray_write(ctx, op)
        return
    parts = []
    for tid in op.inputs:
        v = _lv(ctx, op, tid, expand=True)
        if f"op{op.index}/scale{tid}" in ctx.meta:
            val = Q.round_ties_away(
                v.to(torch.float32) * ctx.smeta(op, f"scale{tid}")
                + ctx.smeta(op, f"bias{tid}"))
            _, zp_o = _scalar_qp(out_td.quant)
            qmin, qmax = Q.quantized_range(out_td.dtype)
            v = Q.clamp_rounded(val, zp_o, qmin, qmax, out_td.dtype)
        parts.append(v)
    ctx.set_view(op.outputs[0],
                 torch.cat(parts, dim=ctx.smeta(op, "axis") + 1))


def _tensorarray_write(ctx: LowerCtx, op: OpNode) -> None:
    """concat(buf[:i], v, buf[i+1:]) as buf with v scattered in at i
    (band_tpu's lax.dynamic_update_slice, band_tpu/ops/lowerings.py:
    1448-1484): i is the prefix slice's size along the axis, or the
    suffix slice's begin less v's extent; clamped into range as XLA
    clamps it; a device-side index, no host sync.  Each request writes
    at its own index where the index is per request."""
    raw = [ctx.env.get(t) for t in op.inputs]
    markers = [v for v in raw if isinstance(v, _DynSlice)]
    dense = [t for t, v in zip(op.inputs, raw) if not isinstance(v, _DynSlice)]
    if len(dense) != 1 or len(markers) not in (1, 2) or any(
            m.src_tid != markers[0].src_tid for m in markers):
        markers[0].fail()
    axis = ctx.smeta(op, "axis")
    src_tid = markers[0].src_tid
    dim = int(ctx.graph.tensor(src_tid).shape[axis])
    extent = int(ctx.graph.tensor(dense[0]).shape[axis])
    prefix = next((m for m in markers
                   if ctx.graph.tensor(m.begin_tid).is_constant and not np.any(
                       ctx.graph.tensor(m.begin_tid).data)), None)
    if prefix is not None:
        pos = ctx.view(prefix.sizes_tid, prefix.sizes)[:, axis]
    else:
        pos = ctx.view(markers[0].begin_tid, markers[0].begin)[:, axis] \
            - extent
    pos = pos.to(torch.int64).clamp(0, dim - extent)
    src = ctx.view(src_tid, markers[0].src)
    upd = _lv(ctx, op, dense[0]).to(src.dtype)
    n = max(src.shape[0], upd.shape[0], pos.shape[0])
    src = src.expand((n,) + tuple(src.shape[1:]))
    upd = upd.expand((n,) + tuple(upd.shape[1:]))
    idx_shape = [1] * upd.dim()
    idx_shape[0] = pos.shape[0]
    idx = pos.reshape(idx_shape)
    if extent > 1:
        step = [1] * upd.dim()
        step[axis + 1] = extent
        idx = idx + torch.arange(extent, device=pos.device).reshape(step)
    ctx.set_view(op.outputs[0],
                 torch.scatter(src, axis + 1, idx.expand(upd.shape), upd))


def _pad_amounts(graph: Graph, op: OpNode):
    return [tuple(int(v) for v in row)
            for row in graph.tensor(op.inputs[1]).data]


def _prepare_pad(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """F.pad amounts (last axis first, the model's axes only) and the
    fill: the input's zero point (PAD), or the constant of PADV2."""
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
    x = _lv(ctx, op, op.inputs[0])
    ctx.set_view(op.outputs[0], F.pad(x, ctx.smeta(op, "pads"),
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
    x = _lv(ctx, op, op.inputs[0])
    for axis in range(x.dim() - 1):
        key = f"op{op.index}/idx{axis}"
        if key in ctx.params:
            x = x.index_select(axis + 1, ctx.params[key])
    ctx.set_view(op.outputs[0], x)


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
    parts = torch.split(_lv(ctx, op, ctx.smeta(op, "x")),
                        list(ctx.smeta(op, "sizes")),
                        dim=ctx.smeta(op, "axis") + 1)
    for tid, part in zip(op.outputs, parts):
        ctx.set_view(tid, part.contiguous())


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
    return out


@register("RESIZE_NEAREST_NEIGHBOR", prepare=_prepare_resize,
          static_inputs=(1,))
def _resize_nearest(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.arr(op.inputs[0])
    x = x.index_select(1, ctx.param(op, "idx1"))
    ctx.set(op.outputs[0], x.index_select(2, ctx.param(op, "idx2")))


@register("RESIZE_BILINEAR", prepare=_prepare_resize, static_inputs=(1,))
def _resize_bilinear(ctx: LowerCtx, op: OpNode) -> None:
    """band_tpu's float form, for float and quantized tensors alike: along
    rows then columns, lo + (hi - lo) * frac in float32 between as_float
    and store_real."""
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
    xi = torch.from_numpy(_byte_values(x_td.dtype) - zp_i)
    a = torch.from_numpy(alpha_q.astype(np.int64).reshape(-1, 1))
    pos = Q.multiply_by_quantized_multiplier(xi, q1, sh1, "double")
    neg = Q.multiply_by_quantized_multiplier(xi * a, q2, sh2, "double")
    out = torch.where(xi >= 0, pos, neg).to(torch.int64) + zp_o
    qmin, qmax = Q.quantized_range(out_td.dtype)
    return out.clamp(qmin, qmax).numpy().astype(out_td.dtype)


def _byte_values(dtype) -> np.ndarray:
    """[256] int64: the 8-bit value of ``dtype`` whose byte is the index
    (a table over the input byte, Q.apply_lut)."""
    byte = np.arange(256, dtype=np.int64)
    return np.where(byte > np.iinfo(dtype).max, byte - 256, byte)


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


def _real_inputs(ctx: LowerCtx, op: OpNode):
    """``_binary_inputs`` as float32, dequantized where quantized."""
    return [real(ctx, t, v)
            for t, v in zip(op.inputs[:2], _binary_inputs(ctx, op))]


@register("SQUARED_DIFFERENCE")
def _squared_difference(ctx: LowerCtx, op: OpNode) -> None:
    a, b = _real_inputs(ctx, op)
    store_real(ctx, op.outputs[0], torch.square(a - b), view=True)


@register("BATCH_MATMUL")
def _batch_matmul(ctx: LowerCtx, op: OpNode) -> None:
    """matmul in float32 between as_float and store_real, as band_tpu
    computes it (outside any Pallas kernel), under the TF32 rule; per
    request, the request axis a batch dim of the product."""
    a, b = _real_inputs(ctx, op)
    _check_tf32(a, op, TF32_MATMUL)
    store_real(ctx, op.outputs[0], torch.matmul(a, b), view=True)


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


# --------------------------------------------------------------------------
# Output-channel shards: the ops a mesh worker splits across its "tp"
# devices (parallel/mesh.py), and each shard's params
# --------------------------------------------------------------------------

SHARDED_OPS = ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED",
               "TRANSPOSE_CONV")
# the per-output-channel params of the int8 conv family (band_tpu's names)
_CHANNEL_PARAMS = ("w", "bias", "qm", "shift", "mult")


def output_channels(graph: Graph, op: OpNode) -> Optional[Tuple[int, int]]:
    """(output channels, depth multiplier) of an op that a mesh may split
    by output channel: an int8 or uint8 CONV_2D, DEPTHWISE_CONV_2D,
    FULLY_CONNECTED with constant weights, or TRANSPOSE_CONV.  None for
    every other op, float and hybrid ones included: those run whole."""
    if op.opname not in SHARDED_OPS or op.is_custom:
        return None
    w = graph.tensor(op.inputs[1])
    if op.opname == "TRANSPOSE_CONV":
        x_td = graph.tensor(op.inputs[2])
        if (x_td.quant is None or x_td.dtype.kind == "f"
                or graph.tensor(op.outputs[0]).quant is None):
            return None
        return int(w.shape[0]), 1
    if _float_input(graph, op) or (op.opname == "FULLY_CONNECTED"
                                   and _runtime_fc_operands(graph, op)):
        return None
    if op.opname == "DEPTHWISE_CONV_2D":
        oc = int(w.shape[3])
        return oc, oc // int(graph.tensor(op.inputs[0]).shape[-1])
    return int(w.shape[0]), 1  # OHWI conv weights, [out, in] FC weights


def shard_params(graph: Graph, op: OpNode, params: Dict[str, np.ndarray],
                 meta: Dict[str, Any], c0: int, c1: int
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The params (numpy: this package's prepared ones or band_tpu's) and
    the meta overrides of ``op``'s shard that computes output channels
    [c0, c1).  Every per-output-channel array of the op is sliced on its
    last axis as a contiguous copy (kernel B2's direct branch loads its
    weights 8 bytes at a time: never a strided view), whatever its
    length (band_tpu leaves vectors shorter than 8 unsharded, sharding.py
    :36-38, which GSPMD can afford and a slice by hand cannot); a
    per-tensor one (one entry) is kept whole.  A TRANSPOSE_CONV keeps
    each channel's rounding group: its union conv's columns and phase
    vectors are (phase, channel), sliced group by group."""
    oc, _ = output_channels(graph, op)
    prefix = f"op{op.index}/"
    own = {k: np.asarray(v) for k, v in params.items() if k.startswith(prefix)}
    if op.opname != "TRANSPOSE_CONV":
        out = {}
        for k, v in own.items():
            if (k[len(prefix):] in _CHANNEL_PARAMS and v.ndim
                    and v.shape[-1] == oc):
                v = v[..., c0:c1]
            out[k] = np.ascontiguousarray(v)
        return out, {}
    phases = op.options["stride_h"] * op.options["stride_w"]
    out, groups = {}, []
    for g, (g0, g1, rounding) in enumerate(meta[prefix + "groups"]):
        lo, hi = max(g0, c0), min(g1, c1)
        if lo >= hi:
            continue
        for name in _CHANNEL_PARAMS:
            v = own.get(f"{prefix}{name}_{g}")
            if v is not None:
                v = v.reshape(v.shape[:-1] + (phases, g1 - g0))
                out[f"{prefix}{name}_{len(groups)}"] = np.ascontiguousarray(
                    v[..., lo - g0:hi - g0].reshape(v.shape[:-2] + (-1,)))
        groups.append((lo - c0, hi - c0, rounding))
    return out, {prefix + "groups": tuple(groups), prefix + "oc": c1 - c0}


# --------------------------------------------------------------------------
# The support op set: casts, comparisons and logic, select, reductions,
# integer division, index and move ops, segment ops, spectral and 3-D ops
# (band_tpu/ops/lowerings.py:1641, :1955, :2364-2607, :2881-3075).  Each
# runs on request views, the model's axes behind the request axis
# (band_tpu vmaps them).  Numerics follow TFLite 2.21's kernels where they
# fix an order or a rounding that band_tpu leaves to XLA.
# --------------------------------------------------------------------------

def _out_dtype(ctx: LowerCtx, op: OpNode, index: int = 0) -> torch.dtype:
    return Q.torch_dtype(ctx.graph.tensor(op.outputs[index]).dtype)


def _unary(fn):
    def lower(ctx: LowerCtx, op: OpNode) -> None:
        _put(ctx, op, fn(_lv(ctx, op, op.inputs[0])))

    return lower


def _binary(fn):
    def lower(ctx: LowerCtx, op: OpNode) -> None:
        _put(ctx, op, fn(*_binary_inputs(ctx, op)))

    return lower


def _sign(x: torch.Tensor) -> torch.Tensor:
    """TFLite's (0 < x) - (x < 0): +0 for both zeros."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def _right_shift(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """TFLite's arithmetic right shift, the amount clamped to [0, bits-1]."""
    bits = torch.iinfo(x.dtype).bits
    return torch.bitwise_right_shift(x, y.clamp(0, bits - 1).to(x.dtype))


register("CAST")(_unary(lambda x: x))  # _put converts to the output type
register("LOGICAL_NOT")(_unary(torch.logical_not))
register("SIGN")(_unary(_sign))
register("COMPLEX_ABS")(_unary(torch.abs))
register("REAL")(_unary(lambda x: torch.real(x).contiguous()))
register("IMAG")(_unary(lambda x: torch.imag(x).contiguous()))
register("ATAN2")(_binary(torch.atan2))
register("BITWISE_XOR")(_binary(torch.bitwise_xor))
register("RIGHT_SHIFT")(_binary(_right_shift))
register("LOGICAL_AND")(_binary(torch.logical_and))
register("LOGICAL_OR")(_binary(torch.logical_or))


def _prepare_minmax(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """band_tpu's rule (band_tpu/ops/lowerings.py:1930-1952): the raw
    values when both inputs share the output's scale (and the first its
    zero point) or the output is not quantized, else the float form."""
    t1, t2 = graph.tensor(op.inputs[0]), graph.tensor(op.inputs[1])
    out_td = graph.tensor(op.outputs[0])
    raw = out_td.quant is None or (
        t1.quant is not None and t2.quant is not None
        and float(t1.quant.scale[0]) == float(out_td.quant.scale[0])
        and int(t1.quant.zero_point[0]) == int(out_td.quant.zero_point[0])
        and float(t2.quant.scale[0]) == float(out_td.quant.scale[0]))
    d = {"raw": raw}
    d.update(_constant_inputs(graph, op))
    return d


def _minmax(fn):
    def lower(ctx: LowerCtx, op: OpNode) -> None:
        if ctx.smeta(op, "raw"):
            _put(ctx, op, fn(*_binary_inputs(ctx, op)))
        else:
            store_real(ctx, op.outputs[0], fn(*_real_inputs(ctx, op)),
                       view=True)

    return lower


register("MINIMUM", prepare=_prepare_minmax)(_minmax(torch.minimum))
register("MAXIMUM", prepare=_prepare_minmax)(_minmax(torch.maximum))


def _compare_table(td: TensorDef) -> np.ndarray:
    """TFLite's ComparisonQuantized rescale of an 8-bit input
    (comparisons.cc): (x - zp) << 8, then MBQM by the input's own scale
    (QuantizeMultiplierSmallerThanOneExp, double rounding); as a
    256-entry int32 table over the input byte (Q.apply_lut)."""
    s, zp = _scalar_qp(td.quant)
    qm, sh = Q.quantize_multiplier(s)
    v = torch.from_numpy(_byte_values(td.dtype) - zp) << 8
    return Q.multiply_by_quantized_multiplier(v, qm, sh, "double").numpy()


def _prepare_compare(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """Quantized 8-bit inputs, exact numerics: TFLite's
    ComparisonQuantized, each input rescaled by its own table
    (``_compare_table``) and the integers compared (fault C8 in
    ROADMAP.md: band_tpu compares the dequantized float32 values, which
    differs where 256 * scale < 1 maps two codes to one integer).  Fast
    numerics keep band_tpu's float form."""
    d = _constant_inputs(graph, op)
    tds = [graph.tensor(t) for t in op.inputs[:2]]
    if exact and all(td.quant is not None and td.dtype in (np.int8, np.uint8)
                     and float(td.quant.scale[0]) < 1.0 for td in tds):
        for i, td in enumerate(tds):
            d[f"cq{i}"] = _compare_table(td)
    return d


def _comparison(fn):
    def lower(ctx: LowerCtx, op: OpNode) -> None:
        a, b = _binary_inputs(ctx, op)
        if f"op{op.index}/cq0" in ctx.params:
            a, b = (Q.apply_lut(v, ctx.param(op, f"cq{i}"))
                    for i, v in enumerate((a, b)))
        elif ctx.is_quantized(op.inputs[0]) or ctx.is_quantized(op.inputs[1]):
            a, b = _real_inputs(ctx, op)
        _put(ctx, op, fn(a, b))

    return lower


for _name, _fn in {
    "EQUAL": torch.eq,
    "NOT_EQUAL": torch.ne,
    "GREATER": torch.gt,
    "GREATER_EQUAL": torch.ge,
    "LESS": torch.lt,
    "LESS_EQUAL": torch.le,
}.items():
    register(_name, prepare=_prepare_compare)(_comparison(_fn))


def _prepare_select(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """TFLite's SELECT copies the chosen input's bytes (select.cc reads no
    quantization); band_tpu dequantizes and requantizes, which is the
    same bytes when both inputs share the output's parameters.  Where
    they do not, band_tpu's float form."""
    out_td = graph.tensor(op.outputs[0])
    tds = [graph.tensor(t) for t in op.inputs[1:3]]
    raw = all(
        (td.quant is None) == (out_td.quant is None) and td.dtype ==
        out_td.dtype and (td.quant is None or (
            float(td.quant.scale[0]), int(td.quant.zero_point[0])) == (
            float(out_td.quant.scale[0]), int(out_td.quant.zero_point[0])))
        for td in tds)
    d = {"raw": raw}
    d.update(_constant_inputs(graph, op))
    return d


def _select(ctx: LowerCtx, op: OpNode) -> None:
    """where(cond, x, y); a rank-1 condition of SELECT picks rows."""
    rank = len(ctx.graph.tensor(op.outputs[0]).shape)
    cond_tid, t1, t2 = op.inputs[:3]
    cond_rank = len(ctx.graph.tensor(cond_tid).shape)
    cond = _lv(ctx, op, cond_tid, None if cond_rank == 1 else rank)
    if op.opname == "SELECT" and cond_rank == 1 and rank > 1:
        cond = cond.reshape(tuple(cond.shape) + (1,) * (rank - 1))
    a, b = _lv(ctx, op, t1, rank), _lv(ctx, op, t2, rank)
    if ctx.smeta(op, "raw"):
        _put(ctx, op, torch.where(cond, a, b))
        return
    store_real(ctx, op.outputs[0], torch.where(
        cond, real(ctx, t1, a), real(ctx, t2, b)), view=True)


register("SELECT", prepare=_prepare_select)(_select)
register("SELECT_V2", prepare=_prepare_select)(_select)


# FLOOR_DIV and FLOOR_MOD (TFLite floor_div.cc, floor_mod.cc): integers
# floor toward -inf and the remainder takes the divisor's sign; floats as
# TFLite computes them, floor(a / b) and fmod(a, b) moved into the
# divisor's sign (band_tpu's jnp forms round differently on some floats)
def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype.is_floating_point:
        return torch.floor(a / b)
    return torch.div(a, b, rounding_mode="floor")


def _floor_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not a.dtype.is_floating_point:
        return torch.remainder(a, b)
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


register("FLOOR_DIV", prepare=lambda g, op, e: _constant_inputs(g, op))(
    _binary(_floor_div))
register("FLOOR_MOD", prepare=lambda g, op, e: _constant_inputs(g, op))(
    _binary(_floor_mod))


def _axes(ctx: LowerCtx, op: OpNode, tid: int, rank: int) -> Tuple[int, ...]:
    """A static axis input's model axes, behind the request axis."""
    return tuple(sorted({int(v) % rank + 1
                         for v in np.ravel(ctx.static(tid))}))


def _reduce(fn):
    """REDUCE_MIN, REDUCE_ANY, REDUCE_ALL: on the raw values (min commutes
    with the monotonic affine quantization)."""
    def lower(ctx: LowerCtx, op: OpNode) -> None:
        x = ctx.view(op.inputs[0])
        axes = _axes(ctx, op, op.inputs[1], x.dim() - 1)
        ctx.set_view(op.outputs[0], fn(
            x, axes, op.options.get("keep_dims", False)).to(
                _out_dtype(ctx, op)))

    return lower


def _amin(x, axes, keep):
    return torch.amin(x, dim=axes, keepdim=keep)


def _all(x, axes, keep):
    return torch.all(x, dim=axes, keepdim=keep)


def _any(x, axes, keep):
    return torch.any(x, dim=axes, keepdim=keep)


register("REDUCE_MIN", static_inputs=(1,))(_reduce(_amin))
register("REDUCE_ANY", static_inputs=(1,))(_reduce(_any))
register("REDUCE_ALL", static_inputs=(1,))(_reduce(_all))


@register("REDUCE_PROD", static_inputs=(1,))
def _reduce_prod(ctx: LowerCtx, op: OpNode) -> None:
    """TFLite's order: one product per output, left to right over the
    reduced elements in row-major order (reduce.cc); quantized inputs as
    band_tpu's float form."""
    x = real(ctx, op.inputs[0], ctx.view(op.inputs[0])) \
        if ctx.is_quantized(op.inputs[0]) else ctx.view(op.inputs[0])
    axes = _axes(ctx, op, op.inputs[1], x.dim() - 1)
    keep = op.options.get("keep_dims", False)
    rest = [a for a in range(x.dim()) if a not in axes]
    flat = x.permute(rest + list(axes)).flatten(len(rest))
    acc = flat[..., 0]
    for i in range(1, flat.shape[-1]):
        acc = acc * flat[..., i]
    if keep:
        for a in axes:
            acc = acc.unsqueeze(a)
    if ctx.is_quantized(op.inputs[0]):
        store_real(ctx, op.outputs[0], acc, view=True)
    else:
        ctx.set_view(op.outputs[0], acc.to(_out_dtype(ctx, op)))


@register("ARG_MIN", static_inputs=(1,))
def _arg_min(ctx: LowerCtx, op: OpNode) -> None:
    """The first index of the smallest value (TFLite arg_min_max.cc)."""
    x = ctx.view(op.inputs[0])
    (axis,) = _axes(ctx, op, op.inputs[1], x.dim() - 1)
    ctx.set_view(op.outputs[0],
                 torch.argmin(x, dim=axis).to(_out_dtype(ctx, op)))


@register("REVERSE_V2", static_inputs=(1,))
def _reverse_v2(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.view(op.inputs[0])
    ctx.set_view(op.outputs[0], torch.flip(
        x, _axes(ctx, op, op.inputs[1], x.dim() - 1)))


@register("TILE", static_inputs=(1,))
def _tile(ctx: LowerCtx, op: OpNode) -> None:
    reps = tuple(int(v) for v in np.ravel(ctx.static(op.inputs[1])))
    ctx.set_view(op.outputs[0], ctx.view(op.inputs[0]).repeat((1,) + reps))


@register("CUMSUM", static_inputs=(1,))
def _cumsum(ctx: LowerCtx, op: OpNode) -> None:
    """TFLite's cumsum.cc: the running sum along the axis, reversed with
    ``reverse``; with ``exclusive`` each output the sum of the elements
    before it (0 first).  band_tpu subtracts x from the inclusive sum
    instead, which rounds differently on floats."""
    x = ctx.view(op.inputs[0])
    (axis,) = _axes(ctx, op, op.inputs[1], x.dim() - 1)
    if op.options.get("reverse", False):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis).to(x.dtype)
    if op.options.get("exclusive", False):
        first = torch.zeros_like(x.narrow(axis, 0, 1))
        out = torch.cat([first, out.narrow(axis, 0, x.shape[axis] - 1)],
                        dim=axis)
    if op.options.get("reverse", False):
        out = torch.flip(out, (axis,))
    ctx.set_view(op.outputs[0], out)


def _prepare_one_hot(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    d = {"depth": int(np.asarray(graph.tensor(op.inputs[1]).data).reshape(()))}
    d.update(_constant_inputs(graph, op))
    return d


@register("ONE_HOT", prepare=_prepare_one_hot, static_inputs=(1,))
def _one_hot(ctx: LowerCtx, op: OpNode) -> None:
    """where(index == iota, on, off) along ``axis`` (band_tpu/ops/
    lowerings.py:2559); on and off are scalars."""
    idx = _lv(ctx, op, op.inputs[0])
    depth = ctx.smeta(op, "depth")
    axis = _norm_axis(op.options.get("axis", -1), idx.dim()) + 1
    on = _operand(ctx, op, op.inputs[2]).reshape(())
    off = _operand(ctx, op, op.inputs[3]).reshape(())
    shape = [1] * (idx.dim() + 1)
    shape[axis] = depth
    iota = torch.arange(depth, device=idx.device).reshape(shape)
    hot = idx.to(torch.int64).unsqueeze(axis) == iota
    ctx.set_view(op.outputs[0],
                 torch.where(hot, on, off).to(_out_dtype(ctx, op)))


@register("LOCAL_RESPONSE_NORMALIZATION")
def _lrn(ctx: LowerCtx, op: OpNode) -> None:
    """TFLite's LRN (local_response_norm.cc): x * (bias + alpha *
    sum_{c-r..c+r} x^2) ^ -beta over channels, alpha not divided by the
    window, the window summed left to right from 0 (band_tpu differences
    prefix sums, which rounds differently)."""
    x = as_float(ctx, op.inputs[0])
    r = int(op.options.get("radius", 5))
    c = x.shape[-1]
    sq = F.pad(x * x, (r, r))
    acc = torch.zeros_like(x)
    for j in range(2 * r + 1):
        acc = acc + sq[..., j:j + c]
    base = float(op.options.get("bias", 1.0)) + \
        float(op.options.get("alpha", 1.0)) * acc
    store_real(ctx, op.outputs[0],
               x * torch.pow(base, -float(op.options.get("beta", 0.5))))


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 key in the order of x's values, equal values equal: the
    value for integers; for floats the bits, negatives mirrored, and -0
    as +0."""
    if not x.dtype.is_floating_point:
        return x.to(torch.int64)
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


_LOW32 = (1 << 32) - 1


@register("TOPK_V2", static_inputs=(1,))
def _topk_v2(ctx: LowerCtx, op: OpNode) -> None:
    """The k largest values along the last axis, largest first, and among
    equal values the lower index first (TFLite's TopContainer, lax.top_k).
    torch.topk promises no order for ties, so it runs on a key that
    packs the value's order above the inverted index: every key distinct,
    one topk, no sort and no host sync.  int64 values take a stable
    descending sort."""
    x = ctx.view(op.inputs[0])
    k = int(np.asarray(ctx.static(op.inputs[1])).reshape(()))
    if x.dtype == torch.int64:
        _, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        idx = idx[..., :k]
    else:
        pos = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
        key = _order_key(x) * (1 << 32) + (_LOW32 - pos)
        idx = _LOW32 - (torch.topk(key, k, dim=-1).values & _LOW32)
    ctx.set_view(op.outputs[0], torch.gather(x, -1, idx))
    ctx.set_view(op.outputs[1], idx.to(_out_dtype(ctx, op, 1)))


def _nd_index(ctx: LowerCtx, op: OpNode, idx_tid: int):
    """The advanced index of GATHER_ND and SCATTER_ND into a request view
    [B, ...]: an explicit request index, then the index rows' columns (a
    constant's broadcast over the requests)."""
    cols = tuple(_lv(ctx, op, idx_tid).to(torch.int64).unbind(-1))
    req = torch.arange(ctx.batch, device=cols[0].device).reshape(
        (ctx.batch,) + (1,) * (cols[0].dim() - 1))
    return (req,) + cols


@register("GATHER_ND", prepare=lambda g, op, e: _constant_inputs(g, op))
def _gather_nd(ctx: LowerCtx, op: OpNode) -> None:
    """x[idx[..., 0], ..., idx[..., n-1]] per request: each request reads
    its own x, also where an index's first column is 0 (the model's
    batch axis)."""
    x = _lv(ctx, op, op.inputs[0], expand=True)
    ctx.set_view(op.outputs[0], x[_nd_index(ctx, op, op.inputs[1])])


def _prepare_scatter_nd(graph: Graph, op: OpNode,
                        exact: bool) -> Dict[str, Any]:
    d = {"shape": tuple(int(v) for v in graph.tensor(op.inputs[2]).data)}
    d.update(_constant_inputs(graph, op))
    return d


@register("SCATTER_ND", prepare=_prepare_scatter_nd, static_inputs=(2,))
def _scatter_nd(ctx: LowerCtx, op: OpNode) -> None:
    """zeros(shape) with the updates added at the indices, per request
    (duplicate indices add, as TF's op)."""
    idx_tid, upd_tid = op.inputs[:2]
    upd = _lv(ctx, op, upd_tid, expand=True)
    out = torch.zeros((ctx.batch,) + ctx.smeta(op, "shape"), dtype=upd.dtype,
                      device=upd.device)
    ctx.set_view(op.outputs[0], out.index_put_(
        _nd_index(ctx, op, idx_tid), upd, accumulate=True))


def _block_params(ctx: LowerCtx, op: OpNode):
    block = [int(v) for v in np.ravel(ctx.static(op.inputs[1]))]
    pads = np.asarray(ctx.static(op.inputs[2])).reshape(-1, 2)
    return block, [tuple(int(v) for v in row) for row in pads]


@register("SPACE_TO_BATCH_ND", static_inputs=(1, 2))
def _space_to_batch_nd(ctx: LowerCtx, op: OpNode) -> None:
    """band_tpu/ops/lowerings.py:2508 per request: the spatial dims padded
    (with the zero point) and split by their blocks, the blocks moved in
    front of the model's batch axis."""
    x = ctx.view(op.inputs[0])
    block, pads = _block_params(ctx, op)
    qp = ctx.qp(op.inputs[0])
    fill = int(qp.zero_point[0]) if qp is not None else 0
    m = len(block)
    rest = list(x.shape[2 + m:])
    flat = [v for row in reversed(pads) for v in row]
    x = F.pad(x, [0, 0] * len(rest) + flat, value=fill)
    b, n = x.shape[:2]
    split = [b, n]
    for i in range(m):
        split += [x.shape[2 + i] // block[i], block[i]]
    x = x.reshape(split + rest)
    perm = [0] + [2 * i + 3 for i in range(m)] + [1]
    perm += [2 * i + 2 for i in range(m)]
    perm += list(range(2 + 2 * m, x.dim()))
    out = x.permute(perm).reshape(
        [b, n * int(np.prod(block))] + [split[2 + 2 * i] for i in range(m)]
        + rest)
    ctx.set_view(op.outputs[0], out.contiguous())


@register("BATCH_TO_SPACE_ND", static_inputs=(1, 2))
def _batch_to_space_nd(ctx: LowerCtx, op: OpNode) -> None:
    """band_tpu/ops/lowerings.py:2536 per request: the block factors of
    the model's batch axis moved back into the spatial dims, then
    cropped."""
    x = ctx.view(op.inputs[0])
    block, crops = _block_params(ctx, op)
    m = len(block)
    b = x.shape[0]
    n = x.shape[1] // int(np.prod(block))
    rest = list(x.shape[2 + m:])
    spatial = [x.shape[2 + i] for i in range(m)]
    x = x.reshape([b] + block + [n] + spatial + rest)
    perm = [0, m + 1]
    for i in range(m):
        perm += [m + 2 + i, 1 + i]
    perm += list(range(2 + 2 * m, x.dim()))
    x = x.permute(perm).reshape(
        [b, n] + [spatial[i] * block[i] for i in range(m)] + rest)
    index = [slice(None), slice(None)]
    for i, (c0, c1) in enumerate(crops):
        index.append(slice(c0, x.shape[2 + i] - c1))
    ctx.set_view(op.outputs[0], x[tuple(index)].contiguous())


def _prepare_segment(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """The segment count: max(ids) + 1 for SEGMENT_SUM's constant ids (its
    output shape is data-dependent), else the output's static leading
    dim; the num_segments input of the UNSORTED_SEGMENT ops."""
    ids = graph.tensor(op.inputs[1])
    if op.opname != "SEGMENT_SUM":
        n = int(np.ravel(graph.tensor(op.inputs[2]).data)[0])
    elif ids.is_constant:
        n = int(np.max(ids.data)) + 1
    else:
        n = int(graph.tensor(op.outputs[0]).shape[0])
        if n <= 0:
            raise LoweringError(
                f"SEGMENT_SUM op {op.index}: non-constant segment ids need a "
                f"static positive output dim 0, got {n}")
    d = {"segments": n}
    d.update(_constant_inputs(graph, op))
    return d


_SEGMENT = {
    "SEGMENT_SUM": (torch.add, "zero"),
    "UNSORTED_SEGMENT_SUM": (torch.add, "zero"),
    "UNSORTED_SEGMENT_PROD": (torch.mul, "one"),
    "UNSORTED_SEGMENT_MAX": (torch.maximum, "lowest"),
    "UNSORTED_SEGMENT_MIN": (torch.minimum, "highest"),
}


def _segment(ctx: LowerCtx, op: OpNode) -> None:
    """Per request, each segment's rows combined in row order, from the
    identity (TFLite's segment_sum.cc and unsorted_segment.cc); an empty
    segment of MAX or MIN holds the dtype's lowest or highest value, as
    TF's op and band_tpu fill it.  One masked step per data row: no
    atomics, so float sums keep their order on the card too."""
    fn, init = _SEGMENT[op.opname]
    data = _lv(ctx, op, op.inputs[0], expand=True)
    ids = _lv(ctx, op, op.inputs[1], expand=True).to(torch.int64)
    n = ctx.smeta(op, "segments")
    info = (torch.finfo if data.dtype.is_floating_point else torch.iinfo)(
        data.dtype)
    fill = {"zero": 0, "one": 1, "lowest": info.min,
            "highest": info.max}[init]
    out = torch.full((data.shape[0], n) + tuple(data.shape[2:]), fill,
                     dtype=data.dtype, device=data.device)
    seg = torch.arange(n, device=data.device)
    tail = (1,) * (data.dim() - 2)
    for i in range(data.shape[1]):
        hit = (ids[:, i:i + 1] == seg).reshape((data.shape[0], n) + tail)
        out = torch.where(hit, fn(out, data[:, i:i + 1]), out)
    ctx.set_view(op.outputs[0], out)


for _name in _SEGMENT:
    register(_name, prepare=_prepare_segment,
             static_inputs=(() if _name == "SEGMENT_SUM" else (2,)))(_segment)


@register("REVERSE_SEQUENCE",
          prepare=lambda g, op, e: _constant_inputs(g, op))
def _reverse_sequence(ctx: LowerCtx, op: OpNode) -> None:
    """Along seq_dim, the first lens[b] elements of each batch_dim row b
    reversed (band_tpu/ops/lowerings.py:2966), per request."""
    x = _lv(ctx, op, op.inputs[0], expand=True)
    lens = _lv(ctx, op, op.inputs[1], expand=True).to(torch.int64)
    s = int(op.options.get("seq_dim", 0)) + 1
    b = int(op.options.get("batch_dim", 0)) + 1
    pos_shape = [1] * x.dim()
    pos_shape[s] = x.shape[s]
    pos = torch.arange(x.shape[s], device=x.device).reshape(pos_shape)
    len_shape = [1] * x.dim()
    len_shape[0], len_shape[b] = x.shape[0], x.shape[b]
    ln = lens.reshape(len_shape)
    idx = torch.where(pos < ln, ln - 1 - pos, pos).expand(x.shape)
    ctx.set_view(op.outputs[0], torch.gather(x, s, idx))


@register("MATRIX_DIAG")
def _matrix_diag(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.view(op.inputs[0])
    eye = torch.eye(x.shape[-1], dtype=torch.bool, device=x.device)
    ctx.set_view(op.outputs[0], torch.where(
        eye, x.unsqueeze(-1), torch.zeros((), dtype=x.dtype,
                                          device=x.device)))


@register("MATRIX_SET_DIAG")
def _matrix_set_diag(ctx: LowerCtx, op: OpNode) -> None:
    x = _lv(ctx, op, op.inputs[0], expand=True)
    d = _lv(ctx, op, op.inputs[1], expand=True).to(x.dtype)
    ctx.set_view(op.outputs[0], torch.diagonal_scatter(x, d, 0, -2, -1))


@register("CONV_3D")
def _conv3d(ctx: LowerCtx, op: OpNode) -> None:
    """Float 3-D convolution, NDHWC input and DHWIO weights
    (band_tpu/ops/lowerings.py:3025), as F.conv3d in IEEE float32 under
    the TF32 rule; an asymmetric SAME pad is padded first."""
    x = ctx.arr(op.inputs[0])
    w = ctx.arr(op.inputs[1])
    opts = op.options
    st = (opts["stride_d"], opts["stride_h"], opts["stride_w"])
    dil = (opts.get("dilation_d", 1), opts.get("dilation_h", 1),
           opts.get("dilation_w", 1))
    pads = [(0, 0)] * 3
    if opts["padding"] == "SAME":
        pads = [_same_pads(x.shape[1 + i], w.shape[i], st[i], dil[i])
                for i in range(3)]
    _check_tf32(x, op, TF32_CONV)
    xc = x.permute(0, 4, 1, 2, 3)
    if any(a != b for a, b in pads):
        xc = F.pad(xc, [v for p in reversed(pads) for v in p])
        pads = [(0, 0)] * 3
    bias = ctx.arr(op.inputs[2]) if len(op.inputs) > 2 and \
        op.inputs[2] >= 0 else None
    y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), bias, st,
                 tuple(p[0] for p in pads), dil)
    out = _apply_float_activation(y.permute(0, 2, 3, 4, 1).contiguous(),
                                  opts.get("activation", "NONE"))
    ctx.set(op.outputs[0], out.to(_out_dtype(ctx, op)))


@register("RFFT2D", static_inputs=(1,))
def _rfft2d(ctx: LowerCtx, op: OpNode) -> None:
    """The real 2-D FFT over the last two axes at fft_length (cropped or
    zero-padded), complex64 (band_tpu's jnp.fft.rfftn; no Pallas)."""
    fft_len = [int(v) for v in np.ravel(ctx.static(op.inputs[1]))]
    out = torch.fft.rfftn(ctx.view(op.inputs[0]).to(torch.float32),
                          s=fft_len, dim=(-2, -1))
    ctx.set_view(op.outputs[0], out.to(torch.complex64))


# --------------------------------------------------------------------------
# Sequences: GATHER and the fused UNIDIRECTIONAL_SEQUENCE_LSTM
# (band_tpu/ops/lowerings.py:1623, :2636-2768)
# --------------------------------------------------------------------------

def _take_fill(dtype: torch.dtype):
    """jnp.take's fill for an index out of range: NaN for floats, the
    lowest value of a signed integer type, the highest of an unsigned
    one, True for bools."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("GATHER", prepare=lambda g, op, e: _constant_inputs(g, op))
def _gather(ctx: LowerCtx, op: OpNode) -> None:
    """jnp.take(x, indices, axis) per request, for float, int32 and int8
    codes alike (codes are not requantized): an index in [-n, n) counts
    from the end where negative, any other reads jnp.take's fill.  A table
    without a request axis (an Embedding's) is read at every request's
    indices in one index_select; a per-request table at indices without
    one (a loop body reading its TensorArray at the counter) likewise
    along its own axis; per-request tables at per-request indices each
    at their own."""
    x_tid, i_tid = op.inputs[:2]
    x = _lv(ctx, op, x_tid)
    idx = _lv(ctx, op, i_tid).to(torch.int64)
    rank = x.dim() - 1
    axis = _norm_axis(int(op.options.get("axis", 0)), rank) + 1
    n = x.shape[axis]
    ishape = tuple(idx.shape[1:])
    valid = (idx >= -n) & (idx < n)
    safe = torch.remainder(idx, n)
    if x.shape[0] == 1 or idx.shape[0] == 1:
        # one table or one index set: a single index_select
        out = x.index_select(axis, safe.reshape(-1))
        lead, tail = tuple(x.shape[1:axis]), tuple(x.shape[axis + 1:])
        if x.shape[0] == 1:
            # [1, lead, B'*ishape, tail] -> [B', lead, ishape, tail]
            out = out.reshape((1,) + lead + (idx.shape[0],) + ishape + tail)
            out = out.movedim(axis, 0).squeeze(1)
        else:
            out = out.reshape((x.shape[0],) + lead + ishape + tail)
    else:
        req = torch.arange(x.shape[0], device=x.device).reshape(
            (x.shape[0],) + (1,) * len(ishape))
        out = x.movedim(axis, 1)[req, safe]  # [B, ishape, lead, tail]
        k, n_lead = len(ishape), axis - 1
        perm = [0] + [1 + k + j for j in range(n_lead)] + \
            [1 + j for j in range(k)] + list(range(1 + k + n_lead,
                                                   out.dim()))
        out = out.permute(perm)
    vmask = valid.reshape(
        (valid.shape[0],) + (1,) * (axis - 1) + ishape
        + (1,) * (rank - axis))
    out = torch.where(vmask, out, torch.full((), _take_fill(out.dtype),
                                             dtype=out.dtype,
                                             device=out.device))
    ctx.set_view(op.outputs[0], out.contiguous())


def _prepare_lstm(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    """The LSTM's operands in float32 (the int8 ones dequantized, band_tpu's
    float simulation of the 8x8_16 kernel), its gates stacked (i, f, o, c;
    CIFG drops i) into one [G*n_cell, I] input matrix ``w`` and one
    transposed recurrent matrix ``r_t`` [n_out, G*n_cell]; the bias
    ``b`` folded into the input projection unless a per-gate layer norm
    comes between; peepholes ``p_i``, ``p_f``, ``p_o``; layer-norm
    coefficients ``ln`` [G, n_cell]; projection ``proj_w_t`` [n_cell,
    n_out] and ``proj_b``; for the int8 form the scales and zero points
    of the input, the states and the output."""
    x_td = graph.tensor(op.inputs[0])
    quantized = x_td.dtype.kind in "iu"
    if quantized and (x_td.dtype != np.int8 or x_td.quant is None):
        raise LoweringError(
            "UNIDIRECTIONAL_SEQUENCE_LSTM: unsupported input type "
            f"{x_td.dtype} (float32 and full-int8 are implemented)")

    def real(i):
        tid = op.inputs[i] if i < len(op.inputs) else -1
        if tid < 0:
            return None
        td = graph.tensor(tid)
        if td.data is None:
            raise LoweringError(
                f"UNIDIRECTIONAL_SEQUENCE_LSTM op {op.index}: runtime "
                f"operand {i} is not ported to PyTorch")
        if td.data.size == 0:
            return None
        v = td.data.astype(np.float32)
        if quantized and td.quant is not None:
            v = (v - np.float32(td.quant.zero_point[0])) * \
                np.float32(td.quant.scale[0])
        return v

    w = {g: real(i) for g, i in zip("ifco", (1, 2, 3, 4))}
    r = {g: real(i) for g, i in zip("ifco", (5, 6, 7, 8))}
    p = {g: real(i) for g, i in zip("ifo", (9, 10, 11))}
    b = {g: real(i) for g, i in zip("ifco", (12, 13, 14, 15))}
    ln = {g: real(i) for g, i in zip("ifco", (20, 21, 22, 23))}
    proj_w, proj_b = real(16), real(17)
    cifg = w["i"] is None
    gates = "foc" if cifg else "ifoc"
    n_cell, n_out = w["f"].shape[0], r["f"].shape[1]
    bias = np.concatenate([b[g] if b[g] is not None
                           else np.zeros(n_cell, np.float32) for g in gates])
    has_ln = ln["f"] is not None
    d: Dict[str, Any] = {
        "w": np.ascontiguousarray(np.concatenate([w[g] for g in gates])),
        "r_t": np.ascontiguousarray(np.concatenate([r[g] for g in gates]).T),
        "b": bias, "gates": gates, "n_cell": n_cell, "n_out": n_out,
        "has_ln": has_ln, "peephole": p["f"] is not None,
        "time_major": bool(op.options.get("time_major", False)),
        "cell_clip": float(op.options.get("cell_clip", 0.0)),
        "proj_clip": float(op.options.get("proj_clip", 0.0)),
        "act": op.options.get("activation", "TANH"),
    }
    for g in "ifo":
        if p[g] is not None:
            d[f"p_{g}"] = p[g]
    if has_ln:
        d["ln"] = np.stack([ln[g] for g in gates])
    if proj_w is not None:
        d["proj_w_t"] = np.ascontiguousarray(proj_w.T)
        if proj_b is not None:
            d["proj_b"] = proj_b
    if quantized:
        h_td, c_td = graph.tensor(op.inputs[18]), graph.tensor(op.inputs[19])
        out_td = graph.tensor(op.outputs[0])
        d.update(x_q=_scalar_qp(x_td.quant), h_q=_scalar_qp(h_td.quant),
                 c_scale=float(c_td.quant.scale[0]),
                 out_q=_scalar_qp(out_td.quant))
    return d


# the profiler ranges of the recurrences (LSTM steps, WHILE iterations)
LSTM_STEPS = "band:lstm_steps"
WHILE_ITERATIONS = "band:while_iterations"


@register("UNIDIRECTIONAL_SEQUENCE_LSTM", prepare=_prepare_lstm)
def _useq_lstm(ctx: LowerCtx, op: OpNode) -> None:
    """band_tpu's semantics (CIFG, peepholes, the output gate's reading
    the updated cell, projection and its clip, per-gate layer norm with
    eps 1e-8 and the bias after the norm, the cell clip, time_major, the
    activation; h0 and c0 zero; the int8 form dequantized, h and c
    fake-quantized with ties away from zero every step, the output
    quantized at the end), on stacked gates: the input projection of
    every step in one GEMM, then per step one recurrent GEMM
    (torch.addmm onto that step's projection) and the pointwise ops on
    the [B * model batch, .] state.  A window's requests are rows of the
    LSTM's batch."""
    m = lambda k: ctx.smeta(op, k)  # noqa: E731
    n, n_out, gates = m("n_cell"), m("n_out"), m("gates")
    cifg, has_ln, peep = gates[0] != "i", m("has_ln"), m("peephole")
    act = functools.partial(_apply_float_activation, activation=m("act"))
    xv = ctx.view(op.inputs[0])
    if f"op{op.index}/x_q" in ctx.meta:
        s, zp = m("x_q")
        xv = (xv.to(torch.float32) - float(zp)) * s
    if m("time_major"):  # [B, T, b, I] -> [B, b, T, I]
        xv = xv.permute(0, 2, 1, 3)
    lead, t_len = xv.shape[:2], xv.shape[2]
    x = xv.reshape(-1, t_len, xv.shape[-1])
    rows = x.shape[0]
    _check_tf32(x, op, TF32_MATMUL)
    w, r_t, b = ctx.param(op, "w"), ctx.param(op, "r_t"), ctx.param(op, "b")
    xp = F.linear(x.reshape(rows * t_len, -1), w, None if has_ln else b)
    xp = xp.reshape(rows, t_len, -1).transpose(0, 1).contiguous()
    quant = f"op{op.index}/h_q" in ctx.meta
    if quant:
        hs_, hzp = m("h_q")
        cs_ = m("c_scale")
    g0 = gates.index("o")  # the sigmoid gates before o: f, or i and f
    p = {g: _optional(ctx, op, f"p_{g}") for g in "ifo"}
    ln = _optional(ctx, op, "ln")
    proj_w, proj_b = _optional(ctx, op, "proj_w_t"), _optional(ctx, op,
                                                                "proj_b")
    clip, pclip = m("cell_clip"), m("proj_clip")

    def norm(z, j):
        # TFLite's MeanStddevNormalization, the gate's coefficient, the bias
        mu = z.mean(dim=-1, keepdim=True)
        var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
        z = (z - mu) * torch.rsqrt(var + 1e-8) * ln[j]
        return z + b[j * n:(j + 1) * n]

    h = torch.zeros((rows, n_out), dtype=torch.float32, device=x.device)
    c = torch.zeros((rows, n), dtype=torch.float32, device=x.device)
    outs = []
    # one profiler range over the recurrence (its share of a request's
    # device time; nearly free when no profiler runs)
    with torch.profiler.record_function(LSTM_STEPS):
        for t in range(t_len):
            z = torch.addmm(xp[t], h, r_t)
            if not (peep or has_ln):
                sig = torch.sigmoid(z[:, :(g0 + 1) * n])
                f = sig[:, (g0 - 1) * n:g0 * n]
                i = 1.0 - f if cifg else sig[:, :n]
                o = sig[:, g0 * n:]
                gc = act(z[:, (g0 + 1) * n:])
            else:
                zs = [z[:, j * n:(j + 1) * n] for j in range(len(gates))]
                for j, g in enumerate(gates):
                    if g in "if" and p[g] is not None:
                        zs[j] = zs[j] + c * p[g]  # the cell before
                    if has_ln and g != "o":
                        zs[j] = norm(zs[j], j)
                f = torch.sigmoid(zs[g0 - 1])
                i = 1.0 - f if cifg else torch.sigmoid(zs[0])
                gc = act(zs[g0 + 1])
            c = f * c + i * gc
            if clip > 0.0:
                c = torch.clamp(c, -clip, clip)
            if quant:
                c = torch.clamp(Q.round_ties_away(c / cs_), -32768,
                                32767) * cs_
            if peep or has_ln:
                zo = zs[g0]
                if p["o"] is not None:
                    zo = zo + c * p["o"]  # the updated cell
                if has_ln:
                    zo = norm(zo, g0)
                o = torch.sigmoid(zo)
            h = o * act(c)
            if proj_w is not None:
                h = h @ proj_w
                if proj_b is not None:
                    h = h + proj_b
                if pclip > 0.0:
                    h = torch.clamp(h, -pclip, pclip)
            if quant:
                qh = torch.clamp(Q.round_ties_away(h / hs_) + hzp, -128, 127)
                h = (qh - hzp) * hs_
            outs.append(h)
    y = torch.stack(outs, dim=1)  # [rows, T, n_out]
    if quant:
        s, zp = m("out_q")
        y = torch.clamp(Q.round_ties_away(y / s) + zp, -128, 127).to(
            torch.int8)
    y = y.reshape(tuple(lead) + (t_len, n_out))
    if m("time_major"):
        y = y.permute(0, 2, 1, 3)
    ctx.set_view(op.outputs[0], y.contiguous())


# --------------------------------------------------------------------------
# Control flow: WHILE and IF over the model's other subgraphs
# (band_tpu/ops/lowerings.py:2771-2877)
# --------------------------------------------------------------------------

CONTROL_FLOW = ("WHILE", "IF")


def child_graphs(graph: Graph, op: OpNode):
    """The subgraphs a WHILE (cond, body) or an IF (then, else) runs."""
    keys = (("cond_subgraph_index", "body_subgraph_index")
            if op.opname == "WHILE"
            else ("then_subgraph_index", "else_subgraph_index"))
    if not graph.subgraphs:
        raise LoweringError(f"{op.opname} op {op.index}: the model has no "
                            "subgraph table")
    return [graph.subgraphs[int(op.options.get(k, 0))] for k in keys]


def _free_inputs(g: Graph, flags) -> FrozenSet[int]:
    return request_free(g, [t for t, f in zip(g.inputs, flags) if f])


def control_free(graph: Graph, op: OpNode, free) -> Tuple[Tuple[bool, ...],
                                                         bool]:
    """(which outputs carry no request axis, whether the condition or
    predicate carries none) of a WHILE or IF whose inputs in ``free``
    carry none.  WHILE: a carry is free if it is free on entry and the
    body keeps it free, a fixed point; a per-request condition ends each
    request at its own iteration, so then no carry is free.  IF: a
    per-request predicate makes every output per request; a free one, an
    output free in both branches."""
    if op.opname == "WHILE":
        cond_g, body_g = child_graphs(graph, op)
        carry = tuple(t in free for t in op.inputs)
        while True:
            bfree = _free_inputs(body_g, carry)
            new = tuple(f and t in bfree
                        for f, t in zip(carry, body_g.outputs))
            if new == carry:
                break
            carry = new
        cond_free = cond_g.outputs[0] in _free_inputs(cond_g, carry)
        return (carry if cond_free else (False,) * len(carry)), cond_free
    if op.inputs[0] not in free:
        return (False,) * len(op.outputs), False
    flags = [t in free for t in op.inputs[1:]]
    outs = [[t in _free_inputs(g, flags) for t in g.outputs]
            for g in child_graphs(graph, op)]
    return tuple(a and b for a, b in zip(*outs)), True


class _Child:
    """A subgraph that a WHILE or IF runs: its ops prepared once with the
    parent's program, their params stored in the parent's under
    ``prefix`` (and so moved to the device with them, once), run eagerly
    on each call with the parent's window."""

    def __init__(self, graph: Graph, exact: bool, prefix: str):
        from ..backend.program import prepare_params

        self.graph = graph
        self.prefix = prefix
        if any(op.is_custom for op in graph.ops):
            raise LoweringError("a control-flow subgraph holds a custom op")
        self.np_params, self.meta = prepare_params(
            graph, range(len(graph.ops)), exact)
        self._free: Dict[Tuple[bool, ...], FrozenSet[int]] = {}

    def params(self, parent: Dict[str, torch.Tensor]):
        k = len(self.prefix)
        return {name[k:]: v for name, v in parent.items()
                if name.startswith(self.prefix)}

    def __call__(self, params, values, flags, batch: int):
        """The subgraph's outputs, and which carry no request axis, for
        inputs ``values`` held as the flags say (free, or stacked)."""
        from .registry import get_lowering

        key = tuple(flags)
        if key not in self._free:
            self._free[key] = _free_inputs(self.graph, key)
        free = self._free[key]
        ctx = LowerCtx(self.graph, params, self.meta, batch=batch, free=free)
        for tid, v in zip(self.graph.inputs, values):
            ctx.set(tid, v)
        for op in self.graph.ops:
            get_lowering(op.opname).trace(ctx, op)
        return ([ctx.arr(t) for t in self.graph.outputs],
                [t in free for t in self.graph.outputs])


def _prepare_control_flow(graph: Graph, op: OpNode,
                          exact: bool) -> Dict[str, Any]:
    d: Dict[str, Any] = {}
    names = ("cond", "body") if op.opname == "WHILE" else ("then", "else")
    for name, g in zip(names, child_graphs(graph, op)):
        child = _Child(g, exact, f"op{op.index}/{name}/")
        d[name] = child
        d.update({f"{name}/{k}": v for k, v in child.np_params.items()})
    d.update(_constant_inputs(graph, op))
    return d


def _held(v: torch.Tensor, shape, was_free: bool, free: bool,
          batch: int) -> torch.Tensor:
    """A value of model shape ``shape`` moved from the held form
    ``was_free`` says to the one ``free`` says: a free value repeated over
    the requests and stacked; otherwise as it is (a per-request value
    never becomes free)."""
    if free or not was_free:
        return v
    shape = tuple(int(s) for s in shape)
    if v.numel() == int(np.prod(shape)):
        v = v.reshape(shape)
    v = v.unsqueeze(0).expand((batch,) + tuple(v.shape))
    return v.reshape((batch * shape[0],) + shape[1:] if shape else (batch,))


def _cf_inputs(ctx: LowerCtx, op: OpNode, tids, flags):
    """The operands ``tids`` held as ``flags`` (free or not) say."""
    return [_held(_operand(ctx, op, t), ctx.graph.tensor(t).shape,
                  t in ctx.free, f, ctx.batch) for t, f in zip(tids, flags)]


def _where_requests(active: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Per request, a where ``active`` [B] holds, else b (stacked forms)."""
    batch = active.shape[0]
    return torch.where(active.reshape(batch, 1), a.reshape(batch, -1),
                       b.reshape(batch, -1)).reshape(b.shape)


@register("WHILE", prepare=_prepare_control_flow)
def _while(ctx: LowerCtx, op: OpNode) -> None:
    """Run body while cond holds, as lax.while_loop.  The condition is
    read on the host, one sync an iteration: where it carries no request
    axis (the Keras loops' counters) one bool serves the window; else the
    loop runs while any request is active and each finished request's
    carries are frozen with torch.where, as jax's batched while_loop
    selects.  Carries keep their types; a carry that is free on entry
    but per request in the loop is repeated over the requests first."""
    cond, body = ctx.smeta(op, "cond"), ctx.smeta(op, "body")
    flags, cond_free = control_free(ctx.graph, op, ctx.free)
    carry = _cf_inputs(ctx, op, op.inputs, flags)
    dtypes = [v.dtype for v in carry]
    with torch.profiler.record_function(WHILE_ITERATIONS):
        carry = _loop(ctx, cond, body, flags, cond_free, carry, dtypes)
    for tid, v in zip(op.outputs, carry):
        ctx.set(tid, v)


def _loop(ctx: LowerCtx, cond: "_Child", body: "_Child", flags, cond_free,
          carry, dtypes):
    cparams, bparams = cond.params(ctx.params), body.params(ctx.params)
    while True:
        (c,), _ = cond(cparams, carry, flags, ctx.batch)
        if cond_free:
            if not bool(c.reshape(-1)[0]):
                break
        else:
            active = c.reshape(ctx.batch).to(torch.bool)
            if not bool(active.any()):
                break
        outs, out_free = body(bparams, carry, flags, ctx.batch)
        if len(outs) != len(carry):
            raise LoweringError(
                f"WHILE: body arity {len(outs)} != carry {len(carry)}")
        new = [_held(v, body.graph.tensor(t).shape, of, f, ctx.batch).to(dt)
               for v, t, of, f, dt in zip(outs, body.graph.outputs, out_free,
                                          flags, dtypes)]
        carry = new if cond_free else [
            _where_requests(active, a, b) for a, b in zip(new, carry)]
    return carry


@register("IF", prepare=_prepare_control_flow)
def _if(ctx: LowerCtx, op: OpNode) -> None:
    """A predicate without a request axis is read on the host and runs one
    branch; a per-request one runs both branches on the window and
    selects per request, as vmap(lax.cond) does."""
    then_c, else_c = ctx.smeta(op, "then"), ctx.smeta(op, "else")
    flags = [t in ctx.free for t in op.inputs[1:]]
    args = _cf_inputs(ctx, op, op.inputs[1:], flags)
    pred_tid = op.inputs[0]
    pred = _operand(ctx, op, pred_tid)
    out_flags = [t in ctx.free for t in op.outputs]

    def run(child):
        outs, free = child(child.params(ctx.params), args, flags, ctx.batch)
        return [_held(v, child.graph.tensor(t).shape, f, of, ctx.batch).to(
                    _out_dtype(ctx, op, k))
                for k, (v, t, f, of) in enumerate(zip(
                    outs, child.graph.outputs, free, out_flags))]

    if pred_tid in ctx.free:
        outs = run(then_c if bool(pred.reshape(-1)[0]) else else_c)
    else:
        active = pred.reshape(ctx.batch).to(torch.bool)
        outs = [_where_requests(active, a, b)
                for a, b in zip(run(then_c), run(else_c))]
    for tid, v in zip(op.outputs, outs):
        ctx.set(tid, v)


# --------------------------------------------------------------------------
# The last op types of band_tpu's registry, per request (band_tpu/ops/
# lowerings.py:1282, :1368, :1374, :1614, :1647, :1903-1927, :2001-2015,
# :2327-2351, :2460, :2625-2633)
# --------------------------------------------------------------------------

@register("ADD_N", prepare=lambda g, op, e: _constant_inputs(g, op))
def _add_n(ctx: LowerCtx, op: OpNode) -> None:
    """The inputs summed left to right."""
    rank = len(ctx.graph.tensor(op.outputs[0]).shape)
    acc = _lv(ctx, op, op.inputs[0], rank)
    for tid in op.inputs[1:]:
        acc = acc + _lv(ctx, op, tid, rank)
    _put(ctx, op, acc)


@register("ARG_MAX", static_inputs=(1,))
def _arg_max(ctx: LowerCtx, op: OpNode) -> None:
    """The first index of the largest value."""
    x = ctx.view(op.inputs[0])
    (axis,) = _axes(ctx, op, op.inputs[1], x.dim() - 1)
    ctx.set_view(op.outputs[0],
                 torch.argmax(x, dim=axis).to(_out_dtype(ctx, op)))


@register("BROADCAST_TO", static_inputs=(1,))
def _broadcast_to(ctx: LowerCtx, op: OpNode) -> None:
    shape = tuple(int(v) for v in np.ravel(ctx.static(op.inputs[1])))
    x = _lv(ctx, op, op.inputs[0], len(shape))
    ctx.set_view(op.outputs[0], x.expand((x.shape[0],) + shape))


@register("DIV", prepare=lambda g, op, e: _constant_inputs(g, op))
def _div(ctx: LowerCtx, op: OpNode) -> None:
    """a / b in float32 with the fused activation, between as_float and
    store_real (integer outputs truncated, as band_tpu's astype)."""
    a, b = _real_inputs(ctx, op)
    store_real(ctx, op.outputs[0], _apply_float_activation(
        a / b, op.options.get("activation", "NONE")), view=True)


@register("POW", prepare=lambda g, op, e: _constant_inputs(g, op))
def _pow(ctx: LowerCtx, op: OpNode) -> None:
    a, b = _real_inputs(ctx, op)
    store_real(ctx, op.outputs[0], torch.pow(a, b), view=True)


def _to_model_shape(ctx: LowerCtx, op: OpNode) -> None:
    """RESHAPE's rule for SQUEEZE and EXPAND_DIMS: the output's model
    shape behind the request axis."""
    x = ctx.view(op.inputs[0])
    out_shape = tuple(int(v) for v in ctx.graph.tensor(op.outputs[0]).shape)
    ctx.set_view(op.outputs[0], x.reshape((x.shape[0],) + out_shape))


register("SQUEEZE")(_to_model_shape)
register("EXPAND_DIMS", static_inputs=(1,))(_to_model_shape)


@register("FILL", prepare=lambda g, op, e: _constant_inputs(g, op),
          static_inputs=(0,))
def _fill(ctx: LowerCtx, op: OpNode) -> None:
    """The value (per request where it is) at every position of the
    static dims."""
    dims = tuple(int(v) for v in np.ravel(ctx.static(op.inputs[0])))
    v = _lv(ctx, op, op.inputs[1])
    v = v.reshape((v.shape[0],) + (1,) * len(dims))
    ctx.set_view(op.outputs[0], v.expand((v.shape[0],) + dims))


@register("L2_NORMALIZATION")
def _l2_norm(ctx: LowerCtx, op: OpNode) -> None:
    """x * rsqrt(sum(x^2) + 1e-6) over the last axis, in float32."""
    x = real(ctx, op.inputs[0], ctx.view(op.inputs[0]))
    norm = torch.rsqrt(torch.sum(torch.square(x), dim=-1, keepdim=True)
                       + 1e-6)
    store_real(ctx, op.outputs[0], x * norm, view=True)


@register("LOG_SOFTMAX")
def _log_softmax(ctx: LowerCtx, op: OpNode) -> None:
    x = real(ctx, op.inputs[0], ctx.view(op.inputs[0]))
    store_real(ctx, op.outputs[0], torch.log_softmax(x, dim=-1), view=True)


def _prepare_rank(graph: Graph, op: OpNode, exact: bool) -> Dict[str, Any]:
    return {"value": np.asarray(len(graph.tensor(op.inputs[0]).shape),
                                np.int32)}


@register("RANK", prepare=_prepare_rank)
def _rank(ctx: LowerCtx, op: OpNode) -> None:
    """The input's model rank, prepared once (a request-free value)."""
    ctx.set(op.outputs[0], ctx.param(op, "value"))


def _amax(x, axes, keep):
    return torch.amax(x, dim=axes, keepdim=keep)


register("REDUCE_MAX", static_inputs=(1,))(_reduce(_amax))


@register("SUM", static_inputs=(1,))
def _sum(ctx: LowerCtx, op: OpNode) -> None:
    """The float32 sum between as_float and store_real, per request."""
    x = real(ctx, op.inputs[0], ctx.view(op.inputs[0]))
    axes = _axes(ctx, op, op.inputs[1], x.dim() - 1)
    store_real(ctx, op.outputs[0], torch.sum(
        x, dim=axes, keepdim=op.options.get("keep_dims", False)), view=True)


@register("UNPACK")
def _unpack(ctx: LowerCtx, op: OpNode) -> None:
    x = ctx.view(op.inputs[0])
    axis = _norm_axis(int(op.options.get("axis", 0)), x.dim() - 1) + 1
    for tid, part in zip(op.outputs, torch.unbind(x, dim=axis)):
        ctx.set_view(tid, part.contiguous())


@register("ZEROS_LIKE")
def _zeros_like(ctx: LowerCtx, op: OpNode) -> None:
    ctx.set(op.outputs[0], torch.zeros_like(ctx.arr(op.inputs[0])))
