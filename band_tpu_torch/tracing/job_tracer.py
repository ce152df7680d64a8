"""Job tracer: Chrome trace_event JSON of the serving timeline.

Every event is a complete (``"ph": "X"``) event timed on
``time.time_ns()`` in µs, with ``pid`` the process (``os.getpid()``) and
``tid`` the native thread id (``threading.get_native_id()``):

- the spans of ``tracing/spans.py`` (``band.request``, ``band.plan``,
  ``band.wait``, ``band.window``, ``band.stage``, the graph ops'
  ``opNNN_NAME``, ``band.retire`` and its parts, ``band.get_outputs``),
  with the job ids of the requests a span belongs to in ``args.jobs``;
- one event per job subgraph execution (the reference's JobTracer +
  chrome_tracer, band/job_tracer.cc:206-247, chrome_tracer/
  tracer.cc:194-265), from the job's ``invoke_time`` to its ``end_time``
  on the worker's dispatch thread, ``args`` the job (``Job.to_json``).

Thread names are written as ``thread_name`` metadata keyed by native tid.

The engine switches it on when the planner has a ``log_path`` and writes
the file there at shutdown.  It shares its clock and thread ids with a
device trace (``Engine.start_device_trace``): torch.profiler's Chrome
trace gives each ``ts`` in µs after its top-level
``baseTimeNanoseconds``, so add ``baseTimeNanoseconds / 1000`` to every
``ts`` of the device trace, concatenate the two ``traceEvents`` lists,
and the two timelines line up.  Unlike the reference's compile-time
macros, tracing toggles at runtime and costs a flag read when off."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class JobTracer:
    def __init__(self) -> None:
        self.enabled = False
        self._users = 0  # engines that switched it on and have not shut down
        self._lock = threading.Lock()
        # (name, cat, ts µs, dur µs, tid, args): tuples, made into events
        # at dump, so that a long trace holds few objects the collector
        # scans
        self._events: List[tuple] = []
        self._threads: Dict[int, str] = {}  # native tid -> thread name

    def enable(self) -> None:
        with self._lock:
            self._users += 1
            self.enabled = True

    def disable(self) -> None:
        """One user fewer; off, with its events dropped, once none is left."""
        with self._lock:
            self._users = max(self._users - 1, 0)
            if self._users == 0:
                self.enabled = False
                self._events = []

    def complete(self, name: str, ts_us: float, dur_us: float,
                 args: Optional[dict] = None, tid: Optional[int] = None,
                 cat: str = "span") -> None:
        """Append one complete event; ``tid`` defaults to the calling
        thread, whose name is kept for the metadata."""
        if tid is None:
            tid = threading.get_native_id()
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name
        self._events.append((name, cat, ts_us, dur_us, tid, args))

    def subgraph(self, job, tid: int) -> None:
        """The job's subgraph execution, from ``invoke_time`` to
        ``end_time`` (now, where the job has none), on the dispatch
        thread ``tid``; nothing for a job never invoked."""
        if not self.enabled or not job.invoke_time:
            return
        end = (job.end_time if job.end_time >= job.invoke_time
               else time.time_ns() // 1000)
        self.complete(
            f"job{job.job_id} m{job.model_id} "
            f"u{sorted(job.subgraph_key.unit_indices)}",
            float(job.invoke_time), float(end - job.invoke_time),
            args=job.to_json(), tid=tid, cat="subgraph")

    def events(self) -> List[dict]:
        """The events so far, without the metadata."""
        pid = os.getpid()
        out = []
        for name, cat, ts, dur, tid, args in list(self._events):
            ev = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
                  "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def dump(self, path: str) -> None:
        pid = os.getpid()
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": name}}
                for tid, name in list(self._threads.items())]
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + self.events()}, f)

    def clear(self) -> None:
        self._events = []


_tracer = JobTracer()


def tracer() -> JobTracer:
    return _tracer
