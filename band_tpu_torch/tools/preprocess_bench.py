"""Preprocessing throughput benchmark: MB/s per image operator.

A port of band_tpu/tools/preprocess_bench.py.  The reference's data
plane is libyuv SIMD (band/buffer/libyuv_image_operator.cc, 1.7k LoC);
ours is numpy + auto-vectorized C++ kernels (buffer/native/image_ops.cc).
For a serving engine fed by images, host preprocessing bounds
achievable req/s — this tool measures each operator and the full
AutoConvert pipeline so that bound is a published number, not a guess.
Every number is the host CPU's (one core): no operator runs on a card.

Usage: python -m band_tpu_torch.tools.preprocess_bench [--json]
Reports MB/s of *input* bytes processed (1080p RGB source unless
stated) and the implied 224x224-model fps per core.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np

from ..buffer.buffer import Buffer, BufferFormat
from ..buffer.image_ops import (
    ColorSpaceConvert,
    Crop,
    Flip,
    Normalize,
    Resize,
    Rotate,
)
from ..buffer.processor import ImageProcessorBuilder


def _run(op_name: str, make_buf, op, budget_s: float = 0.4) -> Dict:
    buf = make_buf()
    nbytes = sum(p.data.nbytes for p in buf.planes)
    op.process(buf)  # warm (native lib build, allocations)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget_s:
        op.process(buf)
        n += 1
    dt = time.perf_counter() - t0
    return {
        "op": op_name,
        "mb_s": round(nbytes * n / dt / 1e6, 1),
        "ms_per_call": round(dt / n * 1000.0, 3),
    }


def run_all(budget_s: float = 0.4) -> list:
    """Every operator and the AutoConvert pipeline, each run for about
    ``budget_s`` seconds after a warm-up call."""
    rng = np.random.default_rng(0)
    h, w = 1080, 1920
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    uv = rng.integers(0, 256, (h // 2 * w)).astype(np.uint8)

    def rgb_buf():
        return Buffer.from_numpy(rgb)

    def nv12_buf():
        return Buffer.from_yuv(y, uv, None, BufferFormat.NV12)

    results = [
        _run("resize_bilinear_1080p->224", rgb_buf, Resize(224, 224),
             budget_s),
        _run("resize_nearest_1080p->224", rgb_buf,
             Resize(224, 224, "nearest"), budget_s),
        _run("nv12_to_rgb_1080p", nv12_buf,
             ColorSpaceConvert(BufferFormat.RGB), budget_s),
        _run("rgb_to_gray_1080p", rgb_buf,
             ColorSpaceConvert(BufferFormat.GRAY), budget_s),
        _run("rotate90_1080p", rgb_buf, Rotate(90), budget_s),
        _run("flip_h_1080p", rgb_buf, Flip(True), budget_s),
        _run("crop_1080p->720p", rgb_buf, Crop(100, 100, 1379, 819),
             budget_s),
        _run("normalize_1080p", rgb_buf, Normalize(127.5, 127.5), budget_s),
        _run("normalize_perchannel_1080p", rgb_buf,
             Normalize([123.7, 116.3, 103.5], [58.4, 57.1, 57.4]), budget_s),
    ]
    # full serving pipeline: 1080p RGB -> 224x224 uint8 model input
    pipe = (
        ImageProcessorBuilder()
        .add_auto_convert((1, 224, 224, 3), np.uint8)
        .build()
    )

    class _PipeOp:
        def process(self, buf):
            return pipe.to_tensor(buf)

    r = _run("auto_convert_1080p->224_uint8", rgb_buf, _PipeOp(), budget_s)
    r["fps_per_core"] = round(1000.0 / r["ms_per_call"], 1)
    results.append(r)
    return results


def main(argv=None) -> int:
    results = run_all()
    argv = argv if argv is not None else sys.argv[1:]
    if "--json" in argv:
        print(json.dumps(results, indent=1))
        return 0
    wid = max(len(r["op"]) for r in results)
    print(f"{'operator':<{wid}}  {'MB/s':>9}  {'ms/call':>8}")
    for r in results:
        print(f"{r['op']:<{wid}}  {r['mb_s']:>9}  {r['ms_per_call']:>8}")
        if "fps_per_core" in r:
            print(f"{'':<{wid}}  -> {r['fps_per_core']} fps/core")
    return 0


if __name__ == "__main__":
    sys.exit(main())
