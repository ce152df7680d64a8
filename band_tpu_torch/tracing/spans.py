"""The port's one span call, and its gate.

``span(name)`` marks one host stage of the serving path.  It feeds two
recorders, and nothing else records spans:

- while a torch.profiler session runs (``profiling``) it enters
  ``torch.profiler.record_function(name)``, so the span lands in the
  device trace (``Engine.start_device_trace``) on its thread;
- while the job tracer is on (tracing/job_tracer.py, the planner's
  ``log_path``) it appends one complete event on ``time.time_ns()``
  with the native thread id and, where it belongs to requests, their
  job ids.

With neither on it costs the flag reads and enters nothing.  Inside a
CUDA graph's capture (``spans_off``) it enters nothing either.

The spans, each on the thread that does the work:

==================== =====================================================
``band.request``     caller: ``Engine.request_async_batch`` (validation,
                     jobs, the input ring, the planner's enqueue)
``band.plan``        planner: one pass that found work (local queues,
                     purges, schedule, enqueue to the workers)
``band.wait``        worker's dispatch thread, while it waits (no job,
                     paused, or its in-flight depth reached; the reason
                     in the job trace's args)
``band.window``      worker's dispatch thread: the dispatch of one window
``band.stage``       inside ``band.window``: the inputs' staging (the ring
                     views, pad, stack, pin, the host-to-device copy)
``opNNN_NAME``       inside ``band.window``: a graph op (backend/program.py)
``band.retire``      retire thread: one drained batch of records, holding
                     ``band.retire.wait`` (the completion event's
                     synchronize) and ``band.retire.finish`` (the latency
                     update, the jobs' completion, the callbacks)
``band.get_outputs`` caller: ``Engine.get_outputs`` (the finished job, the
                     device-to-host copy, the output ring)
==================== =====================================================

``band:lstm_steps`` and ``band:while_iterations`` (ops/lowerings.py) mark
the recurrences inside their graph ops."""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from .job_tracer import tracer

# per thread: a CUDA graph capture in progress, which takes no spans
_no_spans = threading.local()
_autograd_profiler = torch.autograd.profiler
_tracer = tracer()


def profiling() -> bool:
    """Whether a span enters ``record_function`` now: a torch.profiler
    session runs on some thread of the process (the flag torch.profiler
    sets at start and clears at stop; ``torch._C._autograd.
    _profiler_enabled()`` answers for the calling thread only, and the
    engine's workers run on their own) and this thread is not capturing
    a CUDA graph."""
    return (bool(getattr(_autograd_profiler, "_is_profiler_enabled", False))
            and not getattr(_no_spans, "on", False))


def active() -> bool:
    """Whether ``span`` records anything now (a profile or the job tracer
    on, and no capture on this thread)."""
    return ((getattr(_autograd_profiler, "_is_profiler_enabled", False)
             or _tracer.enabled) and not getattr(_no_spans, "on", False))


@contextlib.contextmanager
def spans_off():
    """No spans on this thread in the block (a capture)."""
    _no_spans.on = True
    try:
        yield
    finally:
        _no_spans.on = False


class _Span:
    __slots__ = ("name", "jobs", "args", "rf", "t0")

    def __init__(self, name, jobs, args, rf) -> None:
        self.name, self.jobs, self.args, self.rf = name, jobs, args, rf
        self.t0 = 0

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if _tracer.enabled:
            self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.t0:
            t1 = time.time_ns()
            args = self.args
            if self.jobs is not None:
                args = dict(args or {}, jobs=tuple(
                    getattr(j, "job_id", j) for j in self.jobs))
            _tracer.complete(self.name, self.t0 / 1e3, (t1 - self.t0) / 1e3,
                             args)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, jobs=None, args=None):
    """A context manager that marks one stage as ``name``.  ``jobs``: the
    requests it belongs to (Jobs or job ids, read when the span ends, so
    a list filled inside the span will do); ``args``: more for the job
    trace."""
    if not active():
        return _OFF
    rf = torch.profiler.record_function(name) if profiling() else None
    return _Span(name, jobs, args, rf)
