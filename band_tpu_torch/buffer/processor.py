"""BufferProcessor: a sequential operator pipeline + builder (a port of
band_tpu/buffer/processor.py; reference: band/buffer/buffer_processor.h:
64-107 BufferProcessor / ImageProcessorBuilder)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .buffer import Buffer
from .image_ops import (
    AutoConvert,
    BufferOperator,
    ColorSpaceConvert,
    Crop,
    DataTypeConvert,
    Flip,
    Normalize,
    Resize,
    Rotate,
)


class BufferProcessor:
    def __init__(self, operators: Sequence[BufferOperator]):
        self._ops = list(operators)

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        """Run every operator; ``native=False`` takes each one's numpy
        path (image_ops)."""
        for op in self._ops:
            buf = op.process(buf, native)
        return buf

    def to_tensor(self, buf: Buffer, native: bool = True) -> np.ndarray:
        """Run the pipeline and return an NHWC tensor (batch dim added)."""
        out = self.process(buf, native).array()
        if out.ndim == 2:
            out = out[:, :, None]
        return out[None, ...]


class ImageProcessorBuilder:
    """Fluent pipeline builder (reference: ImageProcessorBuilder).

    An empty builder with a target tensor spec yields the AutoConvert
    pipeline, matching the reference's default behavior."""

    def __init__(self) -> None:
        self._ops: List[BufferOperator] = []

    def add_crop(self, x0: int, y0: int, x1: int, y1: int):
        self._ops.append(Crop(x0, y0, x1, y1))
        return self

    def add_resize(self, width: int, height: int, method: str = "bilinear"):
        self._ops.append(Resize(width, height, method))
        return self

    def add_rotate(self, angle_deg: int):
        self._ops.append(Rotate(angle_deg))
        return self

    def add_flip(self, horizontal: bool = True):
        self._ops.append(Flip(horizontal))
        return self

    def add_color_space_convert(self, target):
        self._ops.append(ColorSpaceConvert(target))
        return self

    def add_normalize(self, mean: float, std: float):
        self._ops.append(Normalize(mean, std))
        return self

    def add_data_type_convert(self, dtype):
        self._ops.append(DataTypeConvert(dtype))
        return self

    def add_auto_convert(self, target_shape, target_dtype):
        self._ops.append(AutoConvert(target_shape, target_dtype))
        return self

    def add(self, op: BufferOperator):
        self._ops.append(op)
        return self

    def build(self) -> BufferProcessor:
        return BufferProcessor(self._ops)
