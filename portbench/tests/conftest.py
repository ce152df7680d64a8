"""CPU tests of the benchmark (``python -m pytest portbench/tests``).
Tests that need a CUDA card look for one inside the test and skip.

``tiny_root`` makes a copy of the benchmark (``BENCHMARK.json`` and
``portbench/``) in a temporary checkout with three cells that the CPU
serves in seconds: ``mnv2_tiny.stream_tiny`` (the full MobileNetV2,
windows of 2), ``sr_tiny.stream_tiny`` and ``sr_tiny.video_tiny`` (FSRCNN
x2 at 24x40), each added to the metric lists of the cell it stands for;
the video cell, which ``BENCHMARK.json`` leaves out, gets the latency
metrics and the per-layer readers written for it.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "tests", "data")

TINY = {
    "mnv2_tiny.stream_tiny": ("mnv2_int8.stream", "mnv2_tiny",
                              "stream_tiny"),
    "sr_tiny.stream_tiny": ("mnv2_int8.stream", "sr_tiny", "stream_tiny"),
    "sr_tiny.video_tiny": ("fsrcnn_x2_int8.video", "sr_tiny", "video_tiny"),
}
VIDEO_METRICS = [
    ("p50_ms", "ms", "end_to_end"), ("p95_ms", "ms", "end_to_end"),
    ("gen_lag_ms.video", "ms", "per_layer"),
    ("queue_ms.video", "ms", "per_layer"),
    ("window_mean.video", "requests", "per_layer"),
    ("mfu.video", "%", "per_layer")]


def copy_benchmark(dst: str) -> str:
    """``BENCHMARK.json`` and ``portbench/`` (no caches) under ``dst``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", ".trace",
                                                  ".scratch", "__pycache__"))
    return dst


def add_tiny_cells(root: str) -> None:
    b = os.path.join(root, "portbench")
    with open(os.path.join(b, "configs", "mnv2_int8.json")) as f:
        cls = json.load(f)
    cls.update(name="mnv2_tiny", max_batch=2,
               model=os.path.join(DATA, "mobilenet_v2_int8.tflite"))
    with open(os.path.join(b, "configs", "fsrcnn_x2_int8.json")) as f:
        sr = json.load(f)
    sr.update(name="sr_tiny", max_batch=4,
              model=os.path.join(DATA, "fsrcnn_x2_small_int8.tflite"))
    for cfg in (cls, sr):
        with open(os.path.join(b, "configs", cfg["name"] + ".json"), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "stream16.json")) as f:
        stream = json.load(f)
    with open(os.path.join(b, "traffic", "video.json")) as f:
        video = json.load(f)
    stream.update(in_flight=4, pool=4)
    video.update(streams=3, pool=4)
    for name, t in (("stream_tiny", stream), ("video_tiny", video)):
        with open(os.path.join(b, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for name, (like, cfg, traffic) in TINY.items():
        bench["workloads"].append(dict(name=name, config=cfg, traffic=traffic,
                                       chips=1, why="a CPU test's cell"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    for name, unit, kind in VIDEO_METRICS:
        m = dict(name=name, unit=unit, better="lower", source="host_clock",
                 workloads=["sr_tiny.video_tiny"])
        if kind == "per_layer":
            m.update(layer="load generator", moves="p95_ms")
        else:
            m["bound"] = 0.25
        bench[kind].append(m)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    from portbench import harness

    monkeypatch.setattr(harness, "WARM_SECONDS", 0.5)
    root = copy_benchmark(str(tmp_path))
    add_tiny_cells(root)
    return root
