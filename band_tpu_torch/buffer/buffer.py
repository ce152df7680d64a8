"""Buffer: multi-plane external image/tensor buffer.

A copy of band_tpu/buffer/buffer.py, which mirrors the reference's Buffer (band/buffer/buffer.h:15-95): pixel
formats (RGB/RGBA/GRAY + planar/semiplanar YUV), EXIF orientation tags
and plane views, backed by numpy instead of raw pointers."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


class BufferFormat(enum.Enum):
    # color formats (reference: band/common.h:132-146)
    GRAY = "gray"
    RGB = "rgb"
    RGBA = "rgba"
    YV12 = "yv12"
    YV21 = "yv21"  # a.k.a. I420
    NV12 = "nv12"
    NV21 = "nv21"
    RAW = "raw"


class BufferOrientation(enum.IntEnum):
    """EXIF orientation (reference: band/common.h:148-161)."""

    TOP_LEFT = 1
    TOP_RIGHT = 2
    BOTTOM_RIGHT = 3
    BOTTOM_LEFT = 4
    LEFT_TOP = 5
    RIGHT_TOP = 6
    RIGHT_BOTTOM = 7
    LEFT_BOTTOM = 8


@dataclass
class DataPlane:
    data: np.ndarray  # 2-D or 3-D plane
    row_stride_bytes: int
    pixel_stride_bytes: int


@dataclass
class Buffer:
    format: BufferFormat
    width: int
    height: int
    planes: List[DataPlane]
    orientation: BufferOrientation = BufferOrientation.TOP_LEFT

    # --- constructors -------------------------------------------------
    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        format: Optional[BufferFormat] = None,
        orientation: BufferOrientation = BufferOrientation.TOP_LEFT,
    ) -> "Buffer":
        """Interleaved single-plane buffer from an HxWxC (or HxW) array."""
        arr = np.ascontiguousarray(arr)
        if arr.ndim == 2:
            fmt = format or BufferFormat.GRAY
            c = 1
        elif arr.ndim == 3 and arr.shape[2] == 3:
            fmt = format or BufferFormat.RGB
            c = 3
        elif arr.ndim == 3 and arr.shape[2] == 4:
            fmt = format or BufferFormat.RGBA
            c = 4
        elif arr.ndim == 3 and arr.shape[2] == 1:
            fmt = format or BufferFormat.GRAY
            c = 1
        else:
            fmt = format or BufferFormat.RAW
            c = arr.shape[2] if arr.ndim == 3 else 1
        h, w = arr.shape[0], arr.shape[1]
        plane = DataPlane(
            data=arr,
            row_stride_bytes=w * c * arr.itemsize,
            pixel_stride_bytes=c * arr.itemsize,
        )
        return Buffer(format=fmt, width=w, height=h, planes=[plane],
                      orientation=orientation)

    @staticmethod
    def from_yuv(
        y: np.ndarray,
        uv_or_u: np.ndarray,
        v: Optional[np.ndarray],
        format: BufferFormat,
        orientation: BufferOrientation = BufferOrientation.TOP_LEFT,
    ) -> "Buffer":
        h, w = y.shape
        planes = [DataPlane(np.ascontiguousarray(y), w, 1)]
        if format in (BufferFormat.NV12, BufferFormat.NV21):
            planes.append(DataPlane(np.ascontiguousarray(uv_or_u), w, 2))
        else:  # planar
            planes.append(DataPlane(np.ascontiguousarray(uv_or_u), w // 2, 1))
            planes.append(DataPlane(np.ascontiguousarray(v), w // 2, 1))
        return Buffer(format=format, width=w, height=h, planes=planes,
                      orientation=orientation)

    # --- accessors ----------------------------------------------------
    @property
    def num_channels(self) -> int:
        return {
            BufferFormat.GRAY: 1,
            BufferFormat.RGB: 3,
            BufferFormat.RGBA: 4,
        }.get(self.format, 3)

    @property
    def is_yuv(self) -> bool:
        return self.format in (
            BufferFormat.YV12,
            BufferFormat.YV21,
            BufferFormat.NV12,
            BufferFormat.NV21,
        )

    def array(self) -> np.ndarray:
        """Interleaved view for single-plane formats."""
        if self.is_yuv:
            raise ValueError("use image_ops.color_convert for YUV buffers")
        return self.planes[0].data

    def clone_with(self, arr: np.ndarray, format: Optional[BufferFormat] = None,
                   orientation: Optional[BufferOrientation] = None) -> "Buffer":
        return Buffer.from_numpy(
            arr,
            format or self.format,
            orientation or self.orientation,
        )
