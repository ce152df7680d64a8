"""Reduces a torch.profiler Chrome trace of the serving window to the
numbers the per-layer metrics read.

The attribution of device time to graph ops is frozen from the
program's trace summary (``band_tpu_torch/tools/xprof_summary.py``): a
device event (kernel, memcpy, memset) leads through its ``correlation``
id to the runtime call that launched it, and that call lies inside the
innermost ``opNNN_NAME`` span of its host thread.  Device busy time is
the union of the device events' intervals, so kernels that overlap are
counted once.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

GRAPH_OP = re.compile(r"^op\d+_\w+$")
OUTSIDE = "(outside any graph op)"
REPLAY = "(CUDA graph replay)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")
TOP = 10
LOOKBACK = 64


class _Spans:
    """Spans of one host thread; ``at`` finds the innermost holding a
    time (of those holding it, the latest to start)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, ts: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, ts)
        # spans nest: one that ended before ts may sit inside a longer one
        # that started earlier, so look back a bounded number of spans
        for j in range(i - 1, max(i - LOOKBACK, 0) - 1, -1):
            if self.spans[j][1] >= ts:
                return self.spans[j][2]
        return None


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceSummary:
    window_s: float  # first to last event of the trace
    busy_s: float  # union of device events
    kernels: int  # kernel events
    device_s: Dict[str, float]  # by graph op (or OUTSIDE / REPLAY)
    worker_op_s: float  # host seconds inside graph-op spans, worker thread
    worker_windows: int  # spans of the program's first graph op, worker
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def summarize(path: str, first_op: str) -> TraceSummary:
    """The summary of the trace at ``path``; ``first_op`` is the span name
    of the program's first graph op, one of which opens each window."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    runtime: Dict[int, Tuple[object, object, float, str]] = {}
    spans: Dict[Tuple[object, object], list] = collections.defaultdict(list)
    host: Dict[Tuple[object, object], list] = collections.defaultdict(list)
    device = []
    t_lo, t_hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
        args = ev.get("args") or {}
        thread = (ev.get("pid"), ev.get("tid"))
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in RUNTIME_CATS and "correlation" in args:
            runtime[args["correlation"]] = thread + (ts, ev.get("name", ""))
        if cat in HOST_CATS:
            host[thread].append((ts, ts + dur, ev.get("name", "?")))
            if cat == "user_annotation" and GRAPH_OP.match(ev.get("name", "")):
                spans[thread].append((ts, ts + dur, ev["name"]))
    threads = {k: _Spans(v) for k, v in spans.items()}
    worker = max(spans, key=lambda k: len(spans[k])) if spans else None

    device_s: collections.Counter = collections.Counter()
    intervals = []
    kernels = 0
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((ts, ts + dur))
        kernels += ev.get("cat") == "kernel"
        launch = runtime.get((ev.get("args") or {}).get("correlation"))
        if launch is None:
            op = OUTSIDE
        elif "GraphLaunch" in launch[3]:
            op = REPLAY
        else:
            t = threads.get((launch[0], launch[1]))
            op = (t.at(launch[2]) if t is not None else None) or OUTSIDE
        device_s[op] += dur / 1e6
    busy = union(intervals)
    worker_spans = spans.get(worker, [])
    summary = TraceSummary(
        window_s=max(t_hi - t_lo, 0.0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        kernels=kernels,
        device_s=dict(device_s),
        worker_op_s=sum(e - s for s, e, _ in worker_spans) / 1e6,
        worker_windows=sum(1 for _, _, n in worker_spans if n == first_op),
    )
    summary.idle_gaps = _idle_gaps(busy, host, worker)
    return summary


def _idle_gaps(busy, host, worker) -> List[Tuple[str, float]]:
    """The longest gaps between device events, each named by the innermost
    host span at its middle: on the worker thread, else on another."""
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    index = {k: _Spans(v) for k, v in host.items()}
    out = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        label = None
        if worker in index:
            name = index[worker].at(mid)
            label = f"worker: {name}" if name else None
        if label is None:
            for k, sp in index.items():
                name = sp.at(mid) if k != worker else None
                if name:
                    label = f"other thread: {name}"
                    break
        out.append((label or "no host span", length / 1e6))
    return out


def top_device_ops(summary: TraceSummary) -> List[Tuple[str, float]]:
    return sorted(summary.device_s.items(), key=lambda kv: -kv[1])[:TOP]


def card_profile():
    """A torch.profiler session of the card's activity alone: kernels,
    copies and memsets, and the runtime calls that launched them, with
    no host ops.  ``card_busy`` reads it once stopped."""
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def _device_kind(e) -> Optional[str]:
    """The kind of a profiler event that is device work, else None."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = kind()
        return kind if kind in DEVICE_CATS else None
    # a torch without activity types: a device event that is not the
    # device-side span of a host annotation (the graph ops', the
    # client's), named by what it did
    import torch

    if e.device_type() != torch._C._autograd.DeviceType.CUDA:
        return None
    name = e.name()
    annotation = getattr(e, "is_user_annotation", None)
    if (annotation is not None and annotation()) or GRAPH_OP.match(name) \
            or name.startswith("portbench."):
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def card_busy(events) -> Tuple[float, Dict[str, int]]:
    """Seconds of the union of the device events (kernels, copies,
    memsets) among ``events`` (a stopped ``card_profile``'s
    ``profiler.kineto_results.events()``), and their count by kind.
    Device-side spans of host annotations are not device work and are
    left out, so the gaps between an op's kernels count as idle."""
    intervals = []
    counts: collections.Counter = collections.Counter()
    for e in events:
        kind = _device_kind(e)
        if kind is None:
            continue
        counts[kind] += 1
        intervals.append((e.start_ns(), e.end_ns()))
    busy = union(intervals)
    return sum(e - s for s, e in busy) / 1e9, dict(counts)
