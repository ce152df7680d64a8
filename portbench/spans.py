"""The program's host spans and counters in a traced run, reduced for the
per-layer metrics of the host's stages.

``band_tpu_torch/tracing/`` puts a ``band.*`` span at each host stage of
a request (``band.request``, ``band.plan``, ``band.wait``,
``band.window``, ``band.stage``, ``band.retire``, ``band.retire.wait``,
``band.retire.finish``, ``band.get_outputs``) and keeps counters at the
same boundaries (``rows_stacked``, ``rows_padded``, ``dispatch_wall_ns``,
``dispatch_cpu_ns``).  ``Engine.stop_device_trace`` keeps the stopped
profiler session and the counters' deltas over it
(``tracing.counters.last_device_trace``): the traced part of the run
(``harness.TRACE_SECONDS``), whose Chrome trace the harness reads and
then removes.  Its events stay in memory, and ``summarize`` reduces them
as Chrome-trace events: each a dict with ``ph``, ``cat``, ``name``,
``ts`` and ``dur`` in µs, ``pid`` and ``tid``.

A program without these (an older commit) gives None, and its metrics
are left out of the result.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench import trace as trace_mod

PREFIX = "band."
WINDOW = "band.window"


@dataclass
class SpanSummary:
    window_s: float  # first to last event of the trace
    spans: Dict[Tuple[object, str], Tuple[float, int]]  # (thread, name) -> (s, n)
    worker: Optional[object]  # the thread with the most graph-op spans
    idle_s: float  # the device's idle time over the window
    idle_in_window_s: float  # of it, inside the worker's band.window spans

    def seconds(self, name: str, thread: object = None) -> float:
        """Seconds in spans ``name``: on ``thread``, else on every one."""
        return sum(s for (t, n), (s, _) in self.spans.items()
                   if n == name and (thread is None or t == thread))


@dataclass
class RunSpans:
    summary: SpanSummary
    counters: Dict[str, int] = field(default_factory=dict)


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _gaps(busy: List[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The complement of ``busy`` (sorted, disjoint) within [lo, hi]."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def summarize(events) -> SpanSummary:
    """The ``band.*`` spans by thread and name, the worker thread (as
    ``trace.summarize`` picks it: the most graph-op spans), and the
    device's idle time, whole and inside the worker's ``band.window``
    spans (idle: the window less the union of kernel, copy and memset
    events, as ``idle_share`` reads it)."""
    spans: Dict[Tuple[object, str], List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    graph_ops: collections.Counter = collections.Counter()
    windows: Dict[object, List[Tuple[float, float]]] = \
        collections.defaultdict(list)
    device = []
    t_lo, t_hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
        thread = (ev.get("pid"), ev.get("tid"))
        if cat in trace_mod.DEVICE_CATS:
            device.append((ts, ts + dur))
        elif cat == "user_annotation":
            if name.startswith(PREFIX):
                acc = spans[(thread, name)]
                acc[0] += dur / 1e6
                acc[1] += 1
                if name == WINDOW:
                    windows[thread].append((ts, ts + dur))
            elif trace_mod.GRAPH_OP.match(name):
                graph_ops[thread] += 1
    worker = max(graph_ops, key=graph_ops.get) if graph_ops else None
    idle_s = inside_s = 0.0
    if device:
        idle = _gaps(trace_mod.union(device), t_lo, t_hi)
        idle_s = sum(e - s for s, e in idle) / 1e6
        inside_s = _overlap(idle, trace_mod.union(windows.get(worker, []))
                            ) / 1e6
    return SpanSummary(
        window_s=max(t_hi - t_lo, 0.0) / 1e6,
        spans={k: (v[0], v[1]) for k, v in spans.items()},
        worker=worker, idle_s=idle_s, idle_in_window_s=inside_s)


def profile_events(profile) -> List[dict]:
    """A stopped torch.profiler session's events as Chrome-trace events:
    ``cat`` its activity type (on a torch without one: a device event's
    kind as ``trace.card_busy`` reads it, a host event a user annotation
    or an op), ``ts`` and ``dur`` in µs of the Unix clock, ``tid`` the
    profiler's id of the host thread."""
    import torch

    cuda = torch._C._autograd.DeviceType.CUDA
    out = []
    for e in profile.profiler.kineto_results.events():
        name = e.name()
        if hasattr(e, "activity_type"):
            cat = e.activity_type()
        elif e.device_type() == cuda:
            cat = (None if name.startswith(PREFIX)
                   else trace_mod._device_kind(e)) or "gpu_user_annotation"
        else:
            annotation = getattr(e, "is_user_annotation", None)
            cat = ("user_annotation" if (annotation is not None
                                         and annotation())
                   or name.startswith(PREFIX)
                   or trace_mod.GRAPH_OP.match(name) else "cpu_op")
        on_device = cat in trace_mod.DEVICE_CATS
        out.append(dict(
            ph="X", cat=cat, name=name, ts=e.start_ns() / 1e3,
            dur=(e.end_ns() - e.start_ns()) / 1e3, pid=0,
            tid=("device", e.device_index()) if on_device
            else e.start_thread_id()))
    return out


def program_trace():
    """The program's last stopped device trace, or None where the program
    keeps none (``band_tpu_torch.tracing.counters``)."""
    try:
        from band_tpu_torch.tracing.counters import last_device_trace
    except ImportError:
        return None
    return last_device_trace()


_cache: Dict[str, object] = {}


def of_run(run) -> Optional[RunSpans]:
    """The spans and counters of a traced run's traced part, or None (an
    untraced run, or a program without them); reduced once for all the
    readers of a run."""
    if run.trace is None:
        return None
    kept = program_trace()
    if kept is None:
        return None
    if _cache.get("trace") is not kept:
        _cache.update(trace=kept, value=RunSpans(
            summarize(profile_events(kept.profile)), dict(kept.counters)))
    return _cache["value"]


def windows(run) -> int:
    """Executor windows in the traced part."""
    return sum(run.trace_windows.values())
