"""Backend-neutral model IR.

The parser lowers a ``.tflite`` FlatBuffer into this IR; executors lower
the IR to PyTorch programs.  Plays the role of the reference's
backend model introspection result (band/backend/tfl/model_executor.cc:48-171)
but as an explicit, serializable graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..tflite.schema import TensorType

_NUMPY_DTYPES = {
    TensorType.FLOAT32: np.float32,
    TensorType.FLOAT16: np.float16,
    TensorType.INT32: np.int32,
    TensorType.UINT8: np.uint8,
    TensorType.INT64: np.int64,
    TensorType.BOOL: np.bool_,
    TensorType.INT16: np.int16,
    TensorType.INT8: np.int8,
    TensorType.FLOAT64: np.float64,
    TensorType.UINT64: np.uint64,
    TensorType.UINT32: np.uint32,
    TensorType.UINT16: np.uint16,
    TensorType.COMPLEX64: np.complex64,
    TensorType.COMPLEX128: np.complex128,
}


def numpy_dtype(t: TensorType):
    if t not in _NUMPY_DTYPES:
        raise ValueError(f"unsupported tensor type {t!r}")
    return np.dtype(_NUMPY_DTYPES[t])


@dataclass
class QuantParams:
    """Affine quantization: real = scale * (q - zero_point).

    ``scale``/``zero_point`` have one element for per-tensor quant or
    C elements (along ``quantized_dimension``) for per-channel weights.
    """

    scale: np.ndarray
    zero_point: np.ndarray
    quantized_dimension: int = 0

    @property
    def per_channel(self) -> bool:
        return self.scale.size > 1

    def __repr__(self) -> str:
        if self.per_channel:
            return (f"QuantParams(per_channel[{self.scale.size}] "
                    f"dim={self.quantized_dimension})")
        return (f"QuantParams(scale={float(self.scale[0]):.6g} "
                f"zp={int(self.zero_point[0])})")


@dataclass
class TensorDef:
    """One tensor in the graph (activation or constant)."""

    index: int
    name: str
    shape: Tuple[int, ...]
    ttype: TensorType
    quant: Optional[QuantParams] = None
    data: Optional[np.ndarray] = None  # constants only

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self.ttype)

    @property
    def is_constant(self) -> bool:
        return self.data is not None

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= max(s, 1)
        return n * self.dtype.itemsize


@dataclass
class OpNode:
    """One operator instance."""

    index: int
    opname: str  # builtin name, e.g. "CONV_2D", or "CUSTOM:<name>"
    inputs: List[int]  # tensor indices; -1 marks an absent optional input
    outputs: List[int]
    options: Dict[str, Any] = field(default_factory=dict)
    version: int = 1

    @property
    def is_custom(self) -> bool:
        return self.opname.startswith("CUSTOM:")

    def __repr__(self) -> str:
        return f"Op#{self.index}:{self.opname}({self.inputs}->{self.outputs})"


@dataclass
class Graph:
    """A parsed model subgraph (TFLite models: the primary subgraph)."""

    name: str
    tensors: List[TensorDef]
    ops: List[OpNode]
    inputs: List[int]
    outputs: List[int]
    description: str = ""
    version: int = 3
    # all subgraphs of the containing model, set when control-flow ops
    # (WHILE/IF) reference sibling subgraphs by index; shared across the
    # model's Graph objects
    subgraphs: Optional[List["Graph"]] = None

    def tensor(self, i: int) -> TensorDef:
        return self.tensors[i]

    def op_input_tensors(self, op: OpNode) -> List[Optional[TensorDef]]:
        return [self.tensors[i] if i >= 0 else None for i in op.inputs]

    def num_ops(self) -> int:
        return len(self.ops)

    def weight_bytes(self) -> int:
        return sum(t.nbytes for t in self.tensors if t.is_constant)

    def op_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for op in self.ops:
            hist[op.opname] = hist.get(op.opname, 0) + 1
        return hist
