"""A frozen reader of ``.tflite`` flatbuffers for the plain reference.

Reads the tensors (shape, type, quantization, constant data), the
operators of the first subgraph and the builtin options of the op set
that the benchmark's models use, straight from the FlatBuffers wire
format (tensorflow/lite/schema/schema.fbs).  It imports nothing of the
program under test: the reference must not share a parser with it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# schema.fbs TensorType -> numpy
_DTYPES = {0: np.float32, 2: np.int32, 3: np.uint8, 4: np.int64,
           7: np.int16, 9: np.int8}
# schema.fbs BuiltinOperator, the codes the reference computes
_OPS = {0: "ADD", 3: "CONV_2D", 4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED",
        25: "SOFTMAX", 40: "MEAN", 45: "STRIDED_SLICE", 54: "PRELU",
        67: "TRANSPOSE_CONV", 77: "SHAPE", 83: "PACK"}
_PADDING = {0: "SAME", 1: "VALID"}
_ACT = {0: "NONE", 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6"}


class _Table:
    """One flatbuffer table: field slots through its vtable."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos

    def _field(self, slot: int) -> int:
        vt = self.pos - struct.unpack_from("<i", self.buf, self.pos)[0]
        vt_len = struct.unpack_from("<H", self.buf, vt)[0]
        if 4 + 2 * slot >= vt_len:
            return 0
        rel = struct.unpack_from("<H", self.buf, vt + 4 + 2 * slot)[0]
        return self.pos + rel if rel else 0

    def scalar(self, slot: int, fmt: str, default=0):
        p = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def _target(self, slot: int) -> int:
        p = self._field(slot)
        return p + struct.unpack_from("<I", self.buf, p)[0] if p else 0

    def table(self, slot: int) -> Optional["_Table"]:
        t = self._target(slot)
        return _Table(self.buf, t) if t else None

    def vector(self, slot: int, dtype) -> np.ndarray:
        v = self._target(slot)
        if not v:
            return np.empty(0, dtype)
        n = struct.unpack_from("<I", self.buf, v)[0]
        return np.frombuffer(self.buf, np.dtype(dtype).newbyteorder("<"),
                             count=n, offset=v + 4)

    def tables(self, slot: int) -> List["_Table"]:
        v = self._target(slot)
        if not v:
            return []
        n = struct.unpack_from("<I", self.buf, v)[0]
        out = []
        for i in range(n):
            p = v + 4 + 4 * i
            out.append(_Table(self.buf,
                              p + struct.unpack_from("<I", self.buf, p)[0]))
        return out


@dataclass
class Tensor:
    shape: tuple
    dtype: np.dtype
    scale: Optional[np.ndarray] = None  # float32, one or one per channel
    zero_point: Optional[np.ndarray] = None  # int64
    data: Optional[np.ndarray] = None  # constants


@dataclass
class Op:
    name: str
    inputs: List[int]
    outputs: List[int]
    options: Dict[str, object] = field(default_factory=dict)


@dataclass
class Model:
    tensors: List[Tensor]
    ops: List[Op]
    inputs: List[int]
    outputs: List[int]


def _options(name: str, t: Optional[_Table]) -> Dict[str, object]:
    """The builtin options of ``name`` (schema.fbs field order)."""
    if t is None:
        return {}
    i8, i32 = (lambda s, d=0: t.scalar(s, "b", d)), (
        lambda s, d=0: t.scalar(s, "i", d))
    if name in ("CONV_2D", "TRANSPOSE_CONV"):
        out = dict(padding=_PADDING[i8(0)], stride_w=i32(1) or 1,
                   stride_h=i32(2) or 1, activation=_ACT[i8(3)])
        if name == "CONV_2D":
            out.update(dilation_w=i32(4, 1), dilation_h=i32(5, 1))
        return out
    if name == "DEPTHWISE_CONV_2D":
        return dict(padding=_PADDING[i8(0)], stride_w=i32(1) or 1,
                    stride_h=i32(2) or 1, depth_multiplier=i32(3),
                    activation=_ACT[i8(4)], dilation_w=i32(5, 1),
                    dilation_h=i32(6, 1))
    if name in ("FULLY_CONNECTED", "ADD"):
        return dict(activation=_ACT[i8(0)])
    if name == "SOFTMAX":
        return dict(beta=t.scalar(0, "f", 1.0))
    if name == "MEAN":
        return dict(keep_dims=bool(t.scalar(0, "B")))
    if name == "STRIDED_SLICE":
        return dict(begin_mask=i32(0), end_mask=i32(1), ellipsis_mask=i32(2),
                    new_axis_mask=i32(3), shrink_axis_mask=i32(4))
    if name == "PACK":
        return dict(values_count=i32(0), axis=i32(1))
    return {}


def read_model(path: str) -> Model:
    """The first subgraph of the ``.tflite`` file at ``path``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[4:8] != b"TFL3":
        raise ValueError(f"{path}: not a TFLite flatbuffer")
    root = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    codes = []
    for c in root.tables(1):
        code = max(c.scalar(0, "b"), c.scalar(3, "i"))
        codes.append(_OPS.get(code, f"UNSUPPORTED_{code}"))
    buffers = root.tables(4)
    sg = root.tables(2)[0]
    tensors = []
    for t in sg.tables(0):
        dtype = np.dtype(_DTYPES[t.scalar(1, "b")])
        shape = tuple(int(v) for v in t.vector(0, np.int32))
        data = None
        b = t.scalar(2, "I")
        if b and b < len(buffers):
            raw = buffers[b].vector(0, np.uint8)
            if raw.size:
                data = np.frombuffer(raw.tobytes(), dtype).reshape(shape)
        q = t.table(4)
        scale = zp = None
        if q is not None and q.vector(2, np.float32).size:
            scale = q.vector(2, np.float32).copy()
            zp = q.vector(3, np.int64).copy()
            if zp.size == 0:
                zp = np.zeros(scale.size, np.int64)
        tensors.append(Tensor(shape, dtype, scale, zp, data))
    ops = []
    for o in sg.tables(3):
        name = codes[o.scalar(0, "I")]
        ops.append(Op(name, [int(v) for v in o.vector(1, np.int32)],
                      [int(v) for v in o.vector(2, np.int32)],
                      _options(name, o.table(4))))
    return Model(tensors, ops, [int(v) for v in sg.vector(1, np.int32)],
                 [int(v) for v in sg.vector(2, np.int32)])
