"""Runs a model read by ``tflite.read_model`` on int8 inputs, op by op,
with the kernels of ``kernels.py``.

``weight_bits=4`` is the benchmark's control: every conv-family weight
is moved to the nearest multiple of 16 (an int4 grid at 16 times the
stored step, clamped to [-128, 112]) before it is used, the precision
below the int8 that the configurations state.  Comparing the program
with the reference must tell the two apart.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import kernels as K
from .tflite import Model, Op


class Reference:
    """One model's reference on ``device``: the constants are moved there
    once, and each call runs a block of requests."""

    def __init__(self, model: Model, device: str = "cpu",
                 weight_bits: int = 8):
        if weight_bits not in (8, 4):
            raise ValueError("weight_bits is 8 or 4")
        self.model = model
        self.device = torch.device(device)
        self.weight_bits = weight_bits
        self._const: Dict[int, torch.Tensor] = {}

    def _weight(self, tid: int) -> torch.Tensor:
        if tid not in self._const:
            w = torch.from_numpy(self.model.tensors[tid].data.astype(np.int64))
            if self.weight_bits == 4:
                w = (torch.round(w / 16.0) * 16).clamp(-128, 112)
            self._const[tid] = w.to(self.device)
        return self._const[tid]

    def _bias(self, op: Op, channels: int) -> torch.Tensor:
        tid = op.inputs[2] if op.name != "TRANSPOSE_CONV" else (
            op.inputs[3] if len(op.inputs) > 3 else -1)
        if tid < 0:
            return torch.zeros(channels, dtype=torch.int64, device=self.device)
        data = self.model.tensors[tid].data.astype(np.int64).reshape(-1)
        return torch.from_numpy(np.broadcast_to(data, (channels,)).copy()).to(
            self.device)

    def _conv_args(self, op: Op, x_tid: int, w_tid: int, channels: int):
        t = self.model.tensors
        tx, tw, to = t[x_tid], t[w_tid], t[op.outputs[0]]
        if tw.zero_point is not None and np.any(tw.zero_point != 0):
            raise ValueError(f"{op.name}: int8 weights with a zero point")
        mult = K.conv_multipliers(float(tx.scale[0]), tw.scale,
                                  float(to.scale[0]), channels)
        zp = int(to.zero_point[0])
        lo, hi = K.activation_range(op.options.get("activation", "NONE"),
                                    float(to.scale[0]), zp)
        return int(tx.zero_point[0]), mult, zp, lo, hi

    def __call__(self, x: np.ndarray) -> List[np.ndarray]:
        """The outputs of a block of requests ``x`` [N, ...] int8."""
        m = self.model
        t = m.tensors
        vals: Dict[int, torch.Tensor] = {
            m.inputs[0]: torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device)}

        def val(tid: int) -> torch.Tensor:
            if tid not in vals:
                vals[tid] = torch.from_numpy(
                    np.array(t[tid].data)).to(self.device)
            return vals[tid]

        for op in m.ops:
            ins, out = op.inputs, op.outputs[0]
            if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                w = self._weight(ins[1])
                co = int(w.shape[0] if op.name == "CONV_2D" else w.shape[3])
                x_zp, mult, zp, lo, hi = self._conv_args(op, ins[0], ins[1],
                                                         co)
                fn = K.conv2d if op.name == "CONV_2D" else K.depthwise_conv2d
                vals[out] = fn(val(ins[0]), x_zp, w, self._bias(op, co),
                               op.options, mult, zp, lo, hi)
            elif op.name == "FULLY_CONNECTED":
                w = self._weight(ins[1])
                co = int(w.shape[0])
                x_zp, mult, zp, lo, hi = self._conv_args(op, ins[0], ins[1],
                                                         co)
                xv = val(ins[0]).reshape(-1, int(w.shape[1]))
                vals[out] = K.fully_connected(xv, x_zp, w, self._bias(op, co),
                                              mult, zp, lo, hi)
            elif op.name == "TRANSPOSE_CONV":
                w = self._weight(ins[1])
                co = int(w.shape[0])
                x_zp, mult, zp, lo, hi = self._conv_args(op, ins[2], ins[1],
                                                         co)
                shape = [int(v) for v in val(ins[0]).cpu()]
                xv = val(ins[2])
                if shape[0] != xv.shape[0] or shape[3] != co:
                    raise ValueError(f"TRANSPOSE_CONV output shape {shape}")
                vals[out] = K.transpose_conv(xv, x_zp, w, self._bias(op, co),
                                             op.options, shape[1:3], mult,
                                             zp, lo, hi)
            elif op.name == "ADD":
                vals[out] = K.add(val(ins[0]), t[ins[0]], val(ins[1]),
                                  t[ins[1]], t[out],
                                  op.options.get("activation", "NONE"))
            elif op.name == "MEAN":
                axes = [int(v) for v in np.ravel(t[ins[1]].data)]
                vals[out] = K.mean(val(ins[0]), t[ins[0]], t[out], axes,
                                   bool(op.options.get("keep_dims")))
            elif op.name == "SOFTMAX":
                vals[out] = K.softmax(val(ins[0]), t[ins[0]], t[out],
                                      float(op.options.get("beta", 1.0)))
            elif op.name == "PRELU":
                vals[out] = K.prelu(val(ins[0]), t[ins[0]], val(ins[1]),
                                    t[ins[1]], t[out])
            elif op.name == "SHAPE":
                vals[out] = torch.tensor(list(val(ins[0]).shape),
                                         dtype=torch.int32)
            elif op.name == "STRIDED_SLICE":
                vals[out] = _strided_slice_1d(
                    val(ins[0]), *(int(np.ravel(t[i].data)[0])
                                   for i in ins[1:4]), op.options)
            elif op.name == "PACK":
                if op.options.get("axis", 0) != 0:
                    raise ValueError("PACK only along axis 0")
                vals[out] = torch.stack([val(i).cpu().reshape(())
                                         for i in ins])
            else:
                raise ValueError(f"op {op.name} is not in the reference")
        return [vals[o].cpu().numpy() for o in m.outputs]


def _strided_slice_1d(x: torch.Tensor, begin: int, end: int, stride: int,
                      opts) -> torch.Tensor:
    """STRIDED_SLICE of a 1-D tensor (masks on its one axis)."""
    x = x.cpu()
    n = x.shape[0]
    if opts.get("ellipsis_mask") or opts.get("new_axis_mask"):
        raise ValueError("STRIDED_SLICE masks beyond begin/end/shrink")
    if opts.get("shrink_axis_mask", 0) & 1:
        return x[begin % n]
    b = 0 if opts.get("begin_mask", 0) & 1 else begin % n
    e = n if opts.get("end_mask", 0) & 1 else (end if end >= 0 else end + n)
    return x[b:e:stride]
