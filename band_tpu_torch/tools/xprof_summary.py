"""Summarize a device trace by kernel, op type, graph op and host span.

The counterpart of band_tpu/tools/xprof_summary.py, which reads a JAX
trace (xplane.pb) and attributes each XLA op to the graph op whose
``jax.named_scope`` emitted it.  Here the trace is the Chrome trace that
``Engine.stop_device_trace`` (runtime/engine.py) or
``torch.profiler.profile.export_chrome_trace`` writes, and the graph op
is the ``record_function("opNNN_NAME")`` span that each program puts
around an op's lowering while a profile runs (backend/program.py).  A
device event (kernel, memcpy, memset) is attributed through its
``correlation`` id: the id leads to the runtime call on the host thread
that launched it, and that call lies inside the innermost opNNN_NAME span
of its thread.

Kernels replayed from a CUDA graph (a co-dispatch combo, a timing
harness) were launched by one ``cudaGraphLaunch``, outside any op span:
they are counted under "(CUDA graph replay)", and the summary says so.

The host's time by stage is the ``band.*`` spans of tracing/spans.py
(``band.request``, ``band.plan``, ``band.wait``, ``band.window``,
``band.stage``, ``band.retire`` and its parts, ``band.get_outputs``),
summed by thread (``host_spans``).

Usage:
    # capture: engine.start_device_trace(dir); requests;
    #          engine.stop_device_trace()
    python -m band_tpu_torch.tools.xprof_summary <trace.json or dir> [top_n]
"""

from __future__ import annotations

import bisect
import collections
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

GRAPH_OP = re.compile(r"^op\d+_\w+$")
HOST_SPAN = "band."
REPLAY = "(CUDA graph replay)"
OUTSIDE = "(outside any graph op)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def load_trace(path: str) -> dict:
    """A Chrome trace: the file, or the newest ``*.json`` in a directory."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.json")),
                       key=os.path.getmtime)
        if not files:
            raise FileNotFoundError(f"no *.json trace under {path}")
        path = files[-1]
    with open(path) as f:
        return json.load(f)


class _Spans:
    """The graph-op spans of one host thread, innermost first."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, ts: float) -> Optional[str]:
        """The innermost span holding ``ts`` (spans nest: a WHILE's body
        inside the WHILE): of those that hold it, the latest to start."""
        i = bisect.bisect_right(self.starts, ts)
        while i > 0:
            i -= 1
            start, end, name = self.spans[i]
            if end >= ts:
                return name
        return None


def _op_type(graph_op: str) -> str:
    """The lowering's op type of a graph op name (op017_TRANSPOSE_CONV ->
    TRANSPOSE_CONV), or the bucket's name."""
    return graph_op.split("_", 1)[1] if GRAPH_OP.match(graph_op) else graph_op


def summarize(path: str, top_n: int = 20) -> Dict[str, object]:
    """Aggregate the device events of a trace.  Returns band_tpu's keys:

    - ``total_ms``: device time of every kernel, memcpy and memset;
    - ``modules``: {bucket: ms} over the graph ops' kernels, CUDA graph
      replays and what ran outside any graph op;
    - ``ops``: [(ms, kernel name, category, op type, launch shape)];
    - ``by_source``: [(ms, op type)], the lowering's op type of each
      graph op (band_tpu's source line);
    - ``by_graph_op``: [(device ms, graph op, host ms)], the host ms the
      sum of the op's span durations on every thread.
    """
    events = load_trace(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    runtime: Dict[int, Tuple[object, object, float, str]] = {}
    spans: Dict[Tuple[object, object], list] = collections.defaultdict(list)
    host_ms: collections.Counter = collections.Counter()
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in RUNTIME_CATS and "correlation" in args:
            runtime[args["correlation"]] = (ev.get("pid"), ev.get("tid"),
                                            float(ev["ts"]), ev["name"])
        elif cat == "user_annotation" and GRAPH_OP.match(ev.get("name", "")):
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            spans[(ev.get("pid"), ev.get("tid"))].append(
                (ts, ts + dur, ev["name"]))
            host_ms[ev["name"]] += dur / 1e3
    threads = {k: _Spans(v) for k, v in spans.items()}

    by_kernel: collections.Counter = collections.Counter()
    info: Dict[str, Tuple[str, str, str]] = {}
    by_op: collections.Counter = collections.Counter()
    by_type: collections.Counter = collections.Counter()
    modules: collections.Counter = collections.Counter()
    for ev in device:
        ms = float(ev.get("dur", 0.0)) / 1e3
        args = ev.get("args") or {}
        launch = runtime.get(args.get("correlation"))
        if launch is None:
            op = OUTSIDE
        elif "GraphLaunch" in launch[3]:
            op = REPLAY
        else:
            t = threads.get((launch[0], launch[1]))
            op = (t.at(launch[2]) if t is not None else None) or OUTSIDE
        name = ev.get("name", "?")
        by_kernel[name] += ms
        if name not in info:
            shape = (f"grid {args.get('grid')} block {args.get('block')}"
                     if ev.get("cat") == "kernel" else "")
            info[name] = (ev.get("cat", ""), _op_type(op), shape)
        by_op[op] += ms
        by_type[_op_type(op)] += ms
        modules["graph ops" if GRAPH_OP.match(op) else op] += ms
    for op in host_ms:
        by_op.setdefault(op, 0.0)
    return {
        "total_ms": sum(by_kernel.values()),
        "modules": dict(modules),
        "ops": [(ms, nm) + info[nm]
                for nm, ms in by_kernel.most_common(top_n)],
        "by_source": [(ms, t) for t, ms in by_type.most_common(top_n)],
        "by_graph_op": [(ms, op, host_ms.get(op, 0.0))
                        for op, ms in by_op.most_common(top_n)],
    }


def host_spans(path: str) -> List[Tuple[float, int, str, str]]:
    """The ``band.*`` spans of a trace summed by thread and name:
    [(host ms, count, thread, span)], the most ms first; a thread is its
    name where the trace has one, else its id."""
    events = load_trace(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    names = {(ev.get("pid"), ev.get("tid")): (ev.get("args") or {}).get("name")
             for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    ms: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and ev.get("name", "").startswith(HOST_SPAN)):
            thread = (ev.get("pid"), ev.get("tid"))
            key = (names.get(thread) or f"tid {ev.get('tid')}", ev["name"])
            ms[key] += float(ev.get("dur", 0.0)) / 1e3
            count[key] += 1
    return [(v, count[k]) + k for k, v in ms.most_common()]


def main(argv: Optional[list] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    top_n = int(argv[1]) if len(argv) > 1 else 20
    s = summarize(argv[0], top_n)
    for nm, ms in s["modules"].items():
        print(f"module {ms:9.3f} ms  {nm}")
    print(f"device ops total: {s['total_ms']:.3f} ms")
    if REPLAY in s["modules"]:
        print(f"  ({REPLAY}: kernels a CUDA graph replayed carry no graph-op "
              "span; counted under the replay)")
    print("== top ops")
    for ms, nm, cat, src, shape in s["ops"]:
        print(f"  {ms:8.4f} ms  {nm[:48]:50.50}{cat[:12]:12.12}"
              f"{src[:24]:26.26}{shape[:40]}")
    print("== by op type (the lowering)")
    for ms, src in s["by_source"]:
        print(f"  {ms:8.4f} ms  {src}")
    print("== by graph op (record_function spans): device ms, host ms")
    for ms, op, host in s["by_graph_op"]:
        print(f"  {ms:8.4f} ms  {host:8.4f} ms  {op}")
    print("== by host span (band.* spans by thread): host ms, count")
    for ms, n, thread, name in host_spans(argv[0]):
        print(f"  {ms:8.4f} ms  {n:6d}  {thread[:28]:30.30}{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
