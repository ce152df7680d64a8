"""The client side of a run: sends requests into the engine as host
arrays and takes every answer back to the host.

Each request is recorded with the time it was due, the time it was sent
and the time its answer was on the host (``time.perf_counter``), beside
the engine's own stamps of the job (``enqueue_time``, ``invoke_time``,
``end_time``, microseconds of ``time.time_ns``).  The engine's
end-of-request callback only queues the job id; ``COLLECTORS`` collector
threads fetch the outputs (the copy to the host), so a loop may hand
them a function to call on each answer, such as sending the next
request.  A collector's busy time (from taking a job id to the end of
its answer's handling, the loop's send included) is kept per answer, so
a run shows whether the client paces the system.

Every answer is held (``Answers``) against the first answer to the same
pool input: an equal one is counted, a differing one is kept.  Once the
run is over ``Answers.judge`` compares the first answers and the
differing ones with the reference, so every answer is checked without
keeping them all.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

KEPT_ODD = 64  # differing answers kept for the comparison, at most
# threads that take the answers back to the host: they share the
# interpreter lock with the engine's worker, and more of them slowed it
COLLECTORS = 1


@dataclass(slots=True)
class Record:
    pool: int
    due: float
    sent: float = 0.0
    done: Optional[float] = None  # the answer on the host
    ok: bool = False
    failed: bool = False
    enqueue_us: int = 0
    invoke_us: int = 0
    end_us: int = 0
    busy: float = 0.0  # the collector's seconds on this answer


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Byte equality of two answers, eight bytes a comparison."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.nbytes % 8 or not (a.flags.c_contiguous and b.flags.c_contiguous):
        return bool(np.array_equal(a, b))
    return bool((a.reshape(-1).view(np.uint64)
                 == b.reshape(-1).view(np.uint64)).all())


class Answers:
    """Every answer held against the first answer to its pool input."""

    def __init__(self) -> None:
        self.first: Dict[int, List[np.ndarray]] = {}
        self.same: Dict[int, int] = {}
        self.odd: List[tuple] = []
        self.odd_count = 0
        self._lock = threading.Lock()

    def hold(self, pool_idx: int, outs: List[np.ndarray]) -> None:
        with self._lock:
            first = self.first.get(pool_idx)
            if first is None:
                self.first[pool_idx] = [np.array(o) for o in outs]
                self.same[pool_idx] = 1
                return
        equal = all(_same(a, b) for a, b in zip(first, outs))
        with self._lock:
            if equal:
                self.same[pool_idx] += 1
            else:
                self.odd_count += 1
                if len(self.odd) < KEPT_ODD:
                    self.odd.append((pool_idx, [np.array(o) for o in outs]))

    def judge(self, expected: Dict[int, List[np.ndarray]]) -> Dict[str, int]:
        """Held against the reference's outputs per pool input: answers
        that differ from it, and the largest difference in quant units."""
        wrong = max_diff = 0
        kept = [(p, outs, self.same[p]) for p, outs in self.first.items()]
        kept += [(p, outs, 1) for p, outs in self.odd]
        for p, outs, count in kept:
            diff = max(int(np.max(np.abs(a.astype(np.int64)
                                         - b.astype(np.int64))))
                       for a, b in zip(outs, expected[p]))
            if diff:
                wrong += count
            max_diff = max(max_diff, diff)
        # differing answers beyond those kept are wrong by construction:
        # each differs from the first answer to its input, so at most one
        # of the two can equal the reference's
        wrong += self.odd_count - len(self.odd)
        return dict(wrong_answers=wrong, max_abs_diff=max_diff)


class Client:
    def __init__(self, engine, model_id: int, pool: np.ndarray,
                 status_ok) -> None:
        self.engine = engine
        self.model_id = model_id
        self.pool = pool
        self._ok = status_ok
        self.records: Dict[int, Record] = {}
        self.on_answer: Optional[Callable[[Record], None]] = None
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.answers = Answers()
        self._handle = engine.register_callback(
            lambda jid, status: self._queue.put((jid, status)))
        self._threads = [threading.Thread(target=self._collect,
                                          name=f"portbench-collector-{i}",
                                          daemon=True)
                         for i in range(COLLECTORS)]
        for t in self._threads:
            t.start()

    @property
    def collectors(self) -> int:
        return len(self._threads)

    def send(self, pool_idxs, due: float) -> None:
        """Requests for the pool inputs ``pool_idxs``, due at ``due``, sent
        together (``Engine.request_async_batch``)."""
        with torch.profiler.record_function("portbench.send"):
            with self._lock:
                t = time.perf_counter()
                jids = self.engine.request_async_batch(
                    [self.model_id] * len(pool_idxs),
                    [[self.pool[p]] for p in pool_idxs])
                for jid, p in zip(jids, pool_idxs):
                    self.records[jid] = Record(p, due, t)

    def _collect(self) -> None:
        while not self._stop.is_set():
            try:
                jid, status = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            taken = time.perf_counter()
            with self._lock:
                rec = self.records.get(jid)
            if rec is None:
                continue
            if status == self._ok:
                with torch.profiler.record_function("portbench.get_outputs"):
                    outs = self.engine.get_outputs(jid)
                rec.done = time.perf_counter()
                rec.ok = True
                job = self.engine.planner.get_finished_job(jid)
                if job is not None:
                    rec.enqueue_us = job.enqueue_time
                    rec.invoke_us = job.invoke_time
                    rec.end_us = job.end_time
                self.answers.hold(rec.pool, outs)
            else:
                rec.done = time.perf_counter()
                rec.failed = True
            if self.on_answer is not None:
                self.on_answer(rec)
            rec.busy = time.perf_counter() - taken

    def outstanding(self) -> int:
        with self._lock:
            return sum(1 for r in self.records.values() if r.done is None)

    def drain(self, deadline: float) -> None:
        """Wait until every request has its answer, or ``deadline``."""
        while self.outstanding() and time.perf_counter() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        self.on_answer = None
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        self.engine.unregister_callback(self._handle)
