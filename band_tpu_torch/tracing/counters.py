"""The port's counters, at the spans' boundaries (tracing/spans.py).

Process-wide and cumulative: each thread adds to a tally of its own (one
writer, no lock), and ``snapshot`` sums the tallies, so a reader takes
two snapshots and their difference (``delta``), as with
``ModelExecutor.windows``.

- ``rows_stacked``, ``rows_padded``: the rows of a window stacked to its
  bucket, and of those the copies of its first request that fill it
  (backend/executor.py ``_pad``, a combo's too);
- ``dispatch_wall_ns``, ``dispatch_cpu_ns``: ``time.perf_counter_ns()``
  and ``time.thread_time_ns()`` around each ``band.window``
  (``dispatch_clock``), always on: their ratio is the share of a window's
  dispatch in which its thread ran, not waiting for the interpreter
  lock, the CPU or the device;
- ``addsub_plain``: exact ADDs and SUBs lowered to the int64 chain, not qaddsub.

``Engine.start_device_trace`` / ``stop_device_trace`` keep the counters'
deltas over a device trace with the stopped session
(``last_device_trace``), for a reader in the same process."""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

NAMES = ("rows_stacked", "rows_padded", "dispatch_wall_ns",
         "dispatch_cpu_ns", "addsub_plain")

_mine = threading.local()
_lock = threading.Lock()  # taken once per thread, and by snapshot
_tallies: List[Dict[str, int]] = []


def _tally() -> Dict[str, int]:
    t = getattr(_mine, "tally", None)
    if t is None:
        t = _mine.tally = dict.fromkeys(NAMES, 0)
        with _lock:
            _tallies.append(t)
    return t


def rows(stacked: int, padded: int) -> None:
    """A window stacked to ``stacked`` rows, ``padded`` of them fill."""
    t = _tally()
    t["rows_stacked"] += stacked
    t["rows_padded"] += padded


def addsub_plain() -> None:
    """An exact ADD or SUB lowered to the int64 chain."""
    _tally()["addsub_plain"] += 1


@contextlib.contextmanager
def dispatch_clock():
    """Wall and thread CPU time of the block, added to the counters."""
    w, c = time.perf_counter_ns(), time.thread_time_ns()
    try:
        yield
    finally:
        t = _tally()
        t["dispatch_cpu_ns"] += time.thread_time_ns() - c
        t["dispatch_wall_ns"] += time.perf_counter_ns() - w


def snapshot() -> Dict[str, int]:
    with _lock:
        tallies = list(_tallies)
    return {k: sum(t[k] for t in tallies) for k in NAMES}


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


@dataclass
class DeviceTrace:
    """One stopped device trace of ``Engine.start_device_trace``."""

    path: str  # the Chrome trace written
    profile: object  # the stopped torch.profiler session
    counters: Dict[str, int]  # each counter's delta over the trace


_last: Optional[DeviceTrace] = None


def keep_device_trace(trace: DeviceTrace) -> None:
    global _last
    _last = trace


def last_device_trace() -> Optional[DeviceTrace]:
    """The process's last stopped device trace: its file, its session
    (whose events stay readable in memory: ``profile.profiler.
    kineto_results.events()``) and the counters' deltas over it."""
    return _last
