"""The work of a model's conv-family graph ops, from the graph's shapes.

Counts are per graph op, never per kernel call, so they stay the same
whatever kernel, split or fusion the program uses for an op:

- multiply-accumulates (MAC) per request: CONV_2D out_h * out_w * Co *
  kh * kw * Ci; DEPTHWISE_CONV_2D out_h * out_w * Co * kh * kw;
  FULLY_CONNECTED O * K per row; TRANSPOSE_CONV in_h * in_w * Ci * kh *
  kw * Co, each input pixel scattered through the whole kernel, which is
  kh * kw * Ci / (s_h * s_w) MAC per output pixel and channel;
- bytes per window of ``b`` requests: b times the request's input and
  output activations, plus the weights and the int32 bias once a window.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .reference.tflite import Model

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
CONV_FAMILY = ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED",
               "TRANSPOSE_CONV")


@dataclass(frozen=True)
class OpWork:
    index: int
    name: str
    mac: int  # per request
    act_bytes: int  # input + output activations of one request
    const_bytes: int  # weights + bias, read once a window

    @property
    def graph_op(self) -> str:
        """The op's span name in the program's traces (opNNN_NAME)."""
        return f"op{self.index:03d}_{self.name}"

    def ops(self, b: int) -> float:
        return 2.0 * self.mac * b

    def bytes(self, b: int) -> float:
        return float(self.act_bytes * b + self.const_bytes)

    def bound_s(self, b: int) -> float:
        """The least time a window of ``b`` requests can take on the card:
        operations over the int8 peak or bytes over the HBM rate."""
        return max(self.ops(b) / INT8_OPS_PER_S,
                   self.bytes(b) / HBM_BYTES_PER_S)


def _size(shape) -> int:
    return int(np.prod([max(int(s), 1) for s in shape]))


def conv_family(model: Model) -> List[OpWork]:
    """One entry per conv-family op of ``model`` (batch 1 shapes)."""
    t = model.tensors
    out = []
    for i, op in enumerate(model.ops):
        if op.name not in CONV_FAMILY:
            continue
        x_tid = op.inputs[2] if op.name == "TRANSPOSE_CONV" else op.inputs[0]
        w, x, y = t[op.inputs[1]], t[x_tid], t[op.outputs[0]]
        ws = w.shape
        if op.name == "CONV_2D":
            mac = _size(y.shape) * ws[1] * ws[2] * ws[3]
        elif op.name == "DEPTHWISE_CONV_2D":
            mac = _size(y.shape) * ws[1] * ws[2]
        elif op.name == "FULLY_CONNECTED":
            mac = _size(y.shape) * ws[1]
        else:
            mac = _size(x.shape) * ws[0] * ws[1] * ws[2]
        bias_tid = op.inputs[3] if op.name == "TRANSPOSE_CONV" else (
            op.inputs[2] if len(op.inputs) > 2 else -1)
        bias = 4 * _size(t[bias_tid].shape) if bias_tid >= 0 else 0
        itemsize = np.dtype(x.dtype).itemsize
        act = (_size(x.shape) + _size(y.shape)) * itemsize
        out.append(OpWork(i, op.name, int(mac), int(act),
                          int(_size(ws) * np.dtype(w.dtype).itemsize + bias)))
    return out


def mac_per_request(model: Model) -> int:
    return sum(w.mac for w in conv_family(model))


def bound_s(work: List[OpWork], windows: Dict[int, int]) -> float:
    """The least device time of the conv-family ops over ``windows``
    ({bucket: windows run})."""
    return sum(n * w.bound_s(b) for b, n in windows.items() for w in work)
