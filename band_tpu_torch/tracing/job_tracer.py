"""Job tracer: Chrome trace_event JSON of the serving timeline.

Streams = workers (as thread ids), events = job subgraph executions
keyed (job_id, unit set) — the reference's JobTracer + chrome_tracer
(band/job_tracer.cc:206-247, chrome_tracer/tracer.cc:194-265).  Unlike
the reference's compile-time macros, tracing toggles at runtime and is
a few ns when disabled."""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

_TRACE_LOCK = threading.Lock()


class JobTracer:
    def __init__(self) -> None:
        self.enabled = False
        self._events: List[dict] = []
        self._workers: Dict[int, str] = {}
        self._t0 = time.perf_counter_ns()

    def enable(self) -> None:
        self.enabled = True

    def register_worker(self, worker_id: int, name: str) -> None:
        self._workers[worker_id] = name

    def _now(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1000.0  # µs

    def begin_subgraph(self, job) -> None:
        if not self.enabled:
            return
        with _TRACE_LOCK:
            self._events.append(
                {
                    "name": f"job{job.job_id} m{job.model_id} "
                    f"u{sorted(job.subgraph_key.unit_indices)}",
                    "cat": "subgraph",
                    "ph": "B",
                    "pid": 0,
                    "tid": job.subgraph_key.worker_id,
                    "ts": self._now(),
                    "args": job.to_json(),
                }
            )

    def end_subgraph(self, job) -> None:
        if not self.enabled:
            return
        with _TRACE_LOCK:
            self._events.append(
                {
                    "name": f"job{job.job_id} m{job.model_id} "
                    f"u{sorted(job.subgraph_key.unit_indices)}",
                    "cat": "subgraph",
                    "ph": "E",
                    "pid": 0,
                    "tid": job.subgraph_key.worker_id,
                    "ts": self._now(),
                }
            )

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        with _TRACE_LOCK:
            self._events.append(
                {
                    "name": name,
                    "ph": "i",
                    "pid": 0,
                    "tid": 0,
                    "ts": self._now(),
                    "s": "g",
                    "args": args or {},
                }
            )

    def dump(self, path: str) -> None:
        with _TRACE_LOCK:
            meta = [
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": wid,
                    "args": {"name": name},
                }
                for wid, name in self._workers.items()
            ]
            payload = {"traceEvents": meta + self._events}
        with open(path, "w") as f:
            json.dump(payload, f)

    def clear(self) -> None:
        with _TRACE_LOCK:
            self._events.clear()


_tracer = JobTracer()


def tracer() -> JobTracer:
    return _tracer
