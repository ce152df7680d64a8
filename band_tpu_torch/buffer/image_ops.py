"""Image/buffer operators: crop, resize, rotate, flip, color convert,
normalize, data-type convert, auto-convert.

A port of band_tpu/buffer/image_ops.py, which re-implements the
reference's operator set (band/buffer/image_operator.h:28-135,
common_operator.h:27) with numpy implementations and C++ fast paths for
the hot kernels (resize, YUV->RGB, rotate/flip, RGBA->RGB, normalize —
the libyuv analogue, band/buffer/libyuv_image_operator.cc).

Every operator's ``process(buf, native=True)`` runs the C++ kernel on
uint8 data and its numpy path on anything else; ``native=False`` runs
the numpy path on every dtype, the reference the kernels are held to.
The numpy paths are band_tpu's, byte for byte, but for RGB -> GRAY,
which widens every channel before the weighted sum (band_tpu's wraps in
uint8 under NumPy 2; its native kernel, which band_tpu runs, does not)."""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..errors import BandError
from .buffer import Buffer, BufferFormat, BufferOrientation
from .native import load as load_native


class BufferOperator:
    """One step of a BufferProcessor pipeline (reference:
    band/buffer/buffer_processor.h IBufferOperator)."""

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        raise NotImplementedError


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _hwc(src: np.ndarray) -> np.ndarray:
    """A contiguous HxWxC view of an HxW or HxWxC array."""
    c = src.shape[2] if src.ndim == 3 else 1
    return np.ascontiguousarray(src.reshape(src.shape[0], src.shape[1], c))


class Crop(BufferOperator):
    """Crop to the inclusive rect [x0, y0] .. [x1, y1] (reference
    semantics: band/buffer/image_operator.h Crop)."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        if self.x1 >= buf.width or self.y1 >= buf.height or self.x0 < 0 or (
            self.y0 < 0 or self.x0 > self.x1 or self.y0 > self.y1
        ):
            raise BandError(
                f"crop rect ({self.x0},{self.y0})-({self.x1},{self.y1}) "
                f"outside {buf.width}x{buf.height}"
            )
        arr = buf.array()[self.y0 : self.y1 + 1, self.x0 : self.x1 + 1]
        return buf.clone_with(np.ascontiguousarray(arr))


class Resize(BufferOperator):
    def __init__(self, width: int, height: int, method: str = "bilinear"):
        if method not in ("bilinear", "nearest"):
            raise BandError(f"unknown resize method {method}")
        self.width, self.height, self.method = width, height, method

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        src = buf.array()
        src3 = _hwc(src)
        if native and src.dtype == np.uint8:
            out = self._native_resize(src3)
        else:
            out = self._numpy_resize(src3)
        if src.ndim == 2:
            out = out[:, :, 0]
        return buf.clone_with(out)

    def _native_resize(self, src: np.ndarray) -> np.ndarray:
        lib = load_native()
        dst = np.empty((self.height, self.width, src.shape[2]), np.uint8)
        fn = (lib.resize_bilinear_u8 if self.method == "bilinear"
              else lib.resize_nearest_u8)
        fn(_u8ptr(src), src.shape[0], src.shape[1], src.shape[2],
           _u8ptr(dst), self.height, self.width)
        return dst

    def _numpy_resize(self, src: np.ndarray) -> np.ndarray:
        sh, sw = src.shape[0], src.shape[1]
        if self.method == "nearest":
            ys = np.minimum((np.arange(self.height) * sh) // self.height, sh - 1)
            xs = np.minimum((np.arange(self.width) * sw) // self.width, sw - 1)
            return src[ys][:, xs]
        # bilinear, half-pixel centers
        fy = np.clip((np.arange(self.height) + 0.5) * sh / self.height - 0.5,
                     0, sh - 1)
        fx = np.clip((np.arange(self.width) + 0.5) * sw / self.width - 0.5,
                     0, sw - 1)
        y0 = np.floor(fy).astype(np.int64)
        x0 = np.floor(fx).astype(np.int64)
        y1 = np.minimum(y0 + 1, sh - 1)
        x1 = np.minimum(x0 + 1, sw - 1)
        wy = (fy - y0)[:, None, None]
        wx = (fx - x0)[None, :, None]
        a = src[y0][:, x0].astype(np.float32)
        b = src[y0][:, x1].astype(np.float32)
        c_ = src[y1][:, x0].astype(np.float32)
        d = src[y1][:, x1].astype(np.float32)
        top = a + (b - a) * wx
        bot = c_ + (d - c_) * wx
        out = top + (bot - top) * wy
        if src.dtype == np.uint8:
            return np.clip(out + 0.5, 0, 255).astype(np.uint8)
        return out.astype(src.dtype)


class Rotate(BufferOperator):
    """Counter-clockwise rotation by a multiple of 90 degrees."""

    def __init__(self, angle_deg: int):
        if angle_deg % 90 != 0:
            raise BandError("rotation must be a multiple of 90 degrees")
        self.k = (angle_deg // 90) % 4

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        src = buf.array()
        if native and src.dtype == np.uint8:
            src3 = _hwc(src)
            oh, ow = (src.shape[1], src.shape[0]) if self.k % 2 else (
                src.shape[0], src.shape[1]
            )
            dst = np.empty((oh, ow, src3.shape[2]), np.uint8)
            load_native().rotate_u8(_u8ptr(src3), src3.shape[0],
                                    src3.shape[1], src3.shape[2], self.k,
                                    _u8ptr(dst))
            out = dst if src.ndim == 3 else dst[:, :, 0]
        else:
            out = np.ascontiguousarray(np.rot90(src, self.k))
        return buf.clone_with(out)


class Flip(BufferOperator):
    def __init__(self, horizontal: bool = True):
        self.horizontal = horizontal

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        src = buf.array()
        if native and src.dtype == np.uint8:
            src3 = _hwc(src)
            dst = np.empty_like(src3)
            load_native().flip_u8(_u8ptr(src3), src3.shape[0],
                                  src3.shape[1], src3.shape[2],
                                  1 if self.horizontal else 0, _u8ptr(dst))
            out = dst if src.ndim == 3 else dst[:, :, 0]
            return buf.clone_with(out)
        out = src[:, ::-1] if self.horizontal else src[::-1]
        return buf.clone_with(np.ascontiguousarray(out))


class ColorSpaceConvert(BufferOperator):
    def __init__(self, target: BufferFormat):
        self.target = target

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        if buf.format == self.target:
            return buf
        if buf.is_yuv and self.target == BufferFormat.RGB:
            return Buffer.from_numpy(_yuv_to_rgb(buf, native),
                                     BufferFormat.RGB, buf.orientation)
        if buf.format == BufferFormat.RGB and self.target == BufferFormat.GRAY:
            src = np.ascontiguousarray(buf.array())
            if native and src.dtype == np.uint8:
                dst = np.empty(src.shape[:2], np.uint8)
                load_native().rgb_to_gray_u8(
                    _u8ptr(src), src.shape[0] * src.shape[1], _u8ptr(dst))
            else:
                # every channel widened: band_tpu widens only R, and
                # under NumPy 2 129 * G then wraps in uint8
                r, g, b = (src[..., i].astype(np.int32) for i in range(3))
                luma = 66 * r + 129 * g + 25 * b + 128
                dst = np.clip((luma >> 8) + 16, 0, 255).astype(src.dtype)
            return Buffer.from_numpy(dst, BufferFormat.GRAY, buf.orientation)
        if buf.format == BufferFormat.RGBA and self.target == BufferFormat.RGB:
            src = buf.array()
            if native and src.dtype == np.uint8:
                src = np.ascontiguousarray(src)
                dst = np.empty(src.shape[:2] + (3,), np.uint8)
                load_native().rgba_to_rgb_u8(
                    _u8ptr(src), src.shape[0] * src.shape[1], _u8ptr(dst))
                return Buffer.from_numpy(dst, BufferFormat.RGB,
                                         buf.orientation)
            return Buffer.from_numpy(
                np.ascontiguousarray(src[..., :3]), BufferFormat.RGB,
                buf.orientation,
            )
        if buf.format == BufferFormat.GRAY and self.target == BufferFormat.RGB:
            g = buf.array()
            return Buffer.from_numpy(np.repeat(g[..., None], 3, axis=2),
                                     BufferFormat.RGB, buf.orientation)
        raise BandError(
            f"unsupported color conversion {buf.format} -> {self.target}"
        )


def _yuv_to_rgb(buf: Buffer, native: bool = True) -> np.ndarray:
    h, w = buf.height, buf.width
    y = np.ascontiguousarray(buf.planes[0].data)
    if buf.format in (BufferFormat.NV12, BufferFormat.NV21):
        uv = np.ascontiguousarray(buf.planes[1].data).reshape(-1)
        order = 1 if buf.format == BufferFormat.NV21 else 0
        if native:
            dst = np.empty((h, w, 3), np.uint8)
            load_native().nv_to_rgb_u8(_u8ptr(y), _u8ptr(uv), h, w, order,
                                       _u8ptr(dst))
            return dst
        u = uv[order::2].reshape(h // 2, w // 2)
        v = uv[1 - order :: 2].reshape(h // 2, w // 2)
    else:  # planar: YV21/I420 = U then V; YV12 = V then U
        p1 = np.ascontiguousarray(buf.planes[1].data).reshape(h // 2, w // 2)
        p2 = np.ascontiguousarray(buf.planes[2].data).reshape(h // 2, w // 2)
        u, v = (p1, p2) if buf.format == BufferFormat.YV21 else (p2, p1)
        if native:
            dst = np.empty((h, w, 3), np.uint8)
            load_native().i420_to_rgb_u8(
                _u8ptr(y), _u8ptr(np.ascontiguousarray(u)),
                _u8ptr(np.ascontiguousarray(v)), h, w, _u8ptr(dst))
            return dst
    # numpy path, BT.601 studio swing
    uu = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w].astype(np.int32) - 128
    vv = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w].astype(np.int32) - 128
    c = y.astype(np.int32) - 16
    r = (298 * c + 409 * vv + 128) >> 8
    g = (298 * c - 100 * uu - 208 * vv + 128) >> 8
    b = (298 * c + 516 * uu + 128) >> 8
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class Normalize(BufferOperator):
    """(x - mean) / std, output float32.

    mean/std may be scalars or per-channel sequences; per-channel
    applies over the last (channel) axis of an interleaved HWC buffer.
    The native kernel multiplies by 1/std, the numpy path divides by
    std: the two may differ in the last bit of a float32."""

    def __init__(self, mean, std):
        self.per_channel = (
            isinstance(mean, (list, tuple, np.ndarray))
            or isinstance(std, (list, tuple, np.ndarray))
        )
        if self.per_channel:
            self.mean = np.asarray(mean, np.float32).reshape(-1)
            self.std = np.asarray(std, np.float32).reshape(-1)
            if self.mean.size != self.std.size:
                if self.mean.size == 1:
                    self.mean = np.full_like(self.std, self.mean[0])
                elif self.std.size == 1:
                    self.std = np.full_like(self.mean, self.std[0])
                else:
                    raise BandError("mean/std channel counts differ")
        else:
            self.mean, self.std = float(mean), float(std)

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        src = np.ascontiguousarray(buf.array())
        if self.per_channel:
            c = src.shape[-1] if src.ndim == 3 else 1
            if c != self.mean.size:
                raise BandError(
                    f"per-channel normalize: {self.mean.size} channels "
                    f"configured, buffer has {c}"
                )
            if native and src.dtype == np.uint8 and src.ndim == 3:
                dst = np.empty(src.shape, np.float32)
                inv = np.ascontiguousarray(1.0 / self.std)
                mean = np.ascontiguousarray(self.mean)
                load_native().normalize_u8_f32_perchannel(
                    _u8ptr(src), src.shape[0] * src.shape[1], c,
                    _f32ptr(mean), _f32ptr(inv), _f32ptr(dst),
                )
            else:
                dst = (src.astype(np.float32) - self.mean) / self.std
            return buf.clone_with(dst)
        if native and src.dtype == np.uint8:
            dst = np.empty(src.shape, np.float32)
            load_native().normalize_u8_f32(
                _u8ptr(src), src.size, ctypes.c_float(self.mean),
                ctypes.c_float(1.0 / self.std), _f32ptr(dst),
            )
        else:
            dst = (src.astype(np.float32) - self.mean) / self.std
        return buf.clone_with(dst)


class DataTypeConvert(BufferOperator):
    """Cast to ``dtype``: floats are rounded and clipped into an integer
    type; integers are cast with ``astype``, so uint8 codes above 127
    wrap into int8 (band_tpu's semantics, kept byte for byte)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        src = buf.array()
        if src.dtype == self.dtype:
            return buf
        if src.dtype.kind == "f" and self.dtype.kind in "iu":
            info = np.iinfo(self.dtype)
            out = np.clip(np.round(src), info.min, info.max).astype(self.dtype)
        else:
            out = src.astype(self.dtype)
        return buf.clone_with(out)


class OrientationCorrect(BufferOperator):
    """Rotate/flip so the buffer reads TOP_LEFT (EXIF normalization)."""

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        o = buf.orientation
        if o == BufferOrientation.TOP_LEFT:
            return buf
        arr = buf.array()
        if o == BufferOrientation.TOP_RIGHT:
            out = arr[:, ::-1]
        elif o == BufferOrientation.BOTTOM_RIGHT:
            out = arr[::-1, ::-1]
        elif o == BufferOrientation.BOTTOM_LEFT:
            out = arr[::-1]
        elif o == BufferOrientation.LEFT_TOP:
            out = np.rot90(arr, 3)[:, ::-1]
        elif o == BufferOrientation.RIGHT_TOP:
            out = np.rot90(arr, 3)
        elif o == BufferOrientation.RIGHT_BOTTOM:
            out = np.rot90(arr, 1)[:, ::-1]
        else:  # LEFT_BOTTOM
            out = np.rot90(arr, 1)
        return Buffer.from_numpy(np.ascontiguousarray(out), buf.format,
                                 BufferOrientation.TOP_LEFT)


class AutoConvert(BufferOperator):
    """Convert a buffer to match a model input tensor: orientation fix +
    color convert + resize + dtype (reference: image_operator.h
    AutoConvert)."""

    def __init__(self, target_shape: Sequence[int], target_dtype):
        # NHWC tensor shape
        if len(target_shape) == 4:
            _, h, w, c = target_shape
        elif len(target_shape) == 3:
            h, w, c = target_shape
        else:
            raise BandError(f"cannot auto-convert to shape {target_shape}")
        self.h, self.w, self.c = h, w, c
        self.dtype = np.dtype(target_dtype)

    def process(self, buf: Buffer, native: bool = True) -> Buffer:
        buf = OrientationCorrect().process(buf, native)
        target_fmt = {1: BufferFormat.GRAY, 3: BufferFormat.RGB,
                      4: BufferFormat.RGBA}.get(self.c)
        if target_fmt and buf.format != target_fmt:
            buf = ColorSpaceConvert(target_fmt).process(buf, native)
        if buf.width != self.w or buf.height != self.h:
            buf = Resize(self.w, self.h).process(buf, native)
        return DataTypeConvert(self.dtype).process(buf, native)
