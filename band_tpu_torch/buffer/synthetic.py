"""Camera-like frames made from a seed, for tests, tools and the card run.

A frame is a smooth scene (a few low-frequency cosine waves a channel,
random frequencies and phases) plus small integer noise, delivered as a
camera does: interleaved RGB, or NV12 (a full-resolution Y plane and a
half-resolution interleaved UV plane).  numpy only; the same seed gives
the same bytes (``frame_digest`` checks that on another machine)."""

from __future__ import annotations

import hashlib

import numpy as np

from .buffer import Buffer, BufferFormat

WAVES = 3      # cosine waves summed a channel
NOISE = 6      # integer noise in [-NOISE, NOISE]


def _smooth(rng, h: int, w: int, channels: int, mean: float,
            amp: float) -> np.ndarray:
    yy = np.arange(h, dtype=np.float64)[:, None] / h
    xx = np.arange(w, dtype=np.float64)[None, :] / w
    out = np.empty((h, w, channels), np.float64)
    for c in range(channels):
        acc = np.zeros((h, w), np.float64)
        for _ in range(WAVES):
            fy, fx = rng.uniform(0.3, 3.0, 2)
            phase = rng.uniform(0.0, 2.0 * np.pi)
            acc += np.cos(2.0 * np.pi * (fy * yy + fx * xx) + phase)
        out[..., c] = mean + acc * (amp / WAVES)
    return out


def _quantize(rng, v: np.ndarray) -> np.ndarray:
    noise = rng.integers(-NOISE, NOISE + 1, v.shape)
    return np.clip(np.round(v) + noise, 0, 255).astype(np.uint8)


def camera_frame(seed: int, width: int = 1920, height: int = 1080,
                 format: BufferFormat = BufferFormat.RGB) -> Buffer:
    """One frame as a Buffer, RGB or NV12 (even width and height)."""
    rng = np.random.default_rng(seed)
    if format == BufferFormat.RGB:
        rgb = _quantize(rng, _smooth(rng, height, width, 3, 128.0, 110.0))
        return Buffer.from_numpy(rgb, BufferFormat.RGB)
    if format != BufferFormat.NV12:
        raise ValueError(f"camera frames are RGB or NV12, not {format}")
    if width % 2 or height % 2:
        raise ValueError("NV12 needs an even width and height")
    y = _quantize(rng, _smooth(rng, height, width, 1, 128.0, 100.0))[..., 0]
    uv = _quantize(rng, _smooth(rng, height // 2, width // 2, 2, 128.0,
                                40.0))
    return Buffer.from_yuv(y, uv.reshape(height // 2, width), None,
                           BufferFormat.NV12)


def frame_bytes(buf: Buffer) -> bytes:
    """The frame's planes back to back, as a camera's single blob (the
    layout of the C ABI's BandBufferSetFromRawData)."""
    return b"".join(np.ascontiguousarray(p.data).tobytes()
                    for p in buf.planes)


def frame_digest(buf: Buffer) -> str:
    return hashlib.sha256(frame_bytes(buf)).hexdigest()
