"""Heterogeneous-earliest-finish-time scheduler (+ reserved variant)
(reference: band/scheduler/heterogeneous_earliest_finish_time_scheduler.cc:11-141).

Like SEL, but only dispatches to idle (enqueue-ready) workers and
yields non-schedulable jobs to the next round.  The reserved variant
books each dispatched job's *future* subgraph hops into the worker
waiting estimates, so chained jobs don't get double-booked
(reservation logic :59-70 and :129-139)."""

from __future__ import annotations

from typing import Deque, Dict, List, Optional, Set, Tuple

from ..common import Job, ScheduleAction, SubgraphKey, WorkerType
from .base import Scheduler


class HEFTScheduler(Scheduler):
    worker_type = WorkerType.GLOBAL_QUEUE
    needs_fallback_subgraphs = True

    def __init__(self, engine, schedule_window_size: int = 1 << 30,
                 reserve: bool = False):
        super().__init__(engine, schedule_window_size)
        self.reserve = reserve
        # job_id -> {worker_id: reserved µs for future hops}
        self._reservations: Dict[int, Dict[int, int]] = {}

    def _reserved_waiting(self, base: Dict[int, int]) -> Dict[int, int]:
        if not self.reserve:
            return dict(base)
        out = dict(base)
        for res in self._reservations.values():
            for wid, t in res.items():
                out[wid] = out.get(wid, 0) + t
        return out

    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        actions: List[ScheduleAction] = []
        waiting = self._reserved_waiting(self.engine.get_worker_waiting_time())
        idle: Set[int] = set(self.engine.get_idle_workers())
        jobs_to_yield: Set[int] = set()
        window = min(self.window, len(queue))
        for _ in range(window):
            best_job: Optional[Job] = None
            best_key: Optional[SubgraphKey] = None
            largest_shortest = -1
            cache: Dict[Tuple[int, frozenset], Tuple[Optional[SubgraphKey], int]] = {}
            for job in list(queue)[: self.window]:
                if id(job) in jobs_to_yield:
                    continue
                sig = (job.model_id, job.resolved_unit_subgraphs)
                if sig in cache:
                    key, end = cache[sig]
                else:
                    key, end = self.engine.get_subgraph_with_shortest_latency(
                        job, waiting
                    )
                    cache[sig] = (key, end)
                if key is None:
                    continue
                if end > largest_shortest:
                    largest_shortest = end
                    best_job, best_key = job, key
            if best_job is None:
                break
            if best_key.worker_id not in idle:
                jobs_to_yield.add(id(best_job))
                continue
            queue.remove(best_job)
            idle.discard(best_key.worker_id)
            actions.append((best_job, best_key))
            if self.reserve:
                self._update_reservation(best_job, best_key)
            # continuous batching under a global queue (no reference
            # analogue): stack same-(model, progress) window jobs onto
            # the claimed worker — they ride the SAME stacked launch
            stacked = []
            limit = min(
                self.engine.get_worker_batch_limit(best_key.worker_id),
                # cap at the largest warm bucket while the key's bucket
                # executables are still background-warming
                self.engine.ready_batch_limit(best_key),
            )
            if limit > 1:
                sig0 = (best_job.model_id, best_job.resolved_unit_subgraphs)
                for job in list(queue)[: self.window]:
                    if len(stacked) >= limit - 1:
                        break
                    if (job.model_id, job.resolved_unit_subgraphs) == sig0:
                        stacked.append(job)
                for job in stacked:
                    queue.remove(job)
                    actions.append((job, best_key))
                    if self.reserve:
                        self._update_reservation(job, best_key)
            # the whole window is ONE dispatch, priced at its batch-
            # bucket cost (NOT batch-1: a b8 bucket costs ~5x b1,
            # docs/performance.md — batch-blind pricing underestimates
            # waiting times several-fold under load)
            n = 1 + len(stacked)
            best_job.batch_size = n
            for job in stacked:
                job.batch_size = n
            expected = self.engine.get_expected_latency(best_key, n)
            if expected > 0:
                waiting[best_key.worker_id] = (
                    waiting.get(best_key.worker_id, 0) + expected
                )
        return actions

    def _update_reservation(self, job: Job, key: SubgraphKey) -> None:
        """Book the expected cost of the job's remaining hops."""
        self._reservations.pop(job.job_id, None)
        resolved = job.resolved_unit_subgraphs | key.unit_indices
        res: Dict[int, int] = {}
        guard = 0
        probe = Job(model_id=job.model_id, job_id=job.job_id)
        probe.resolved_unit_subgraphs = frozenset(resolved)
        while guard < 64 and not self.engine.is_end_of_model(key, resolved - key.unit_indices):
            nxt, _ = self.engine.get_subgraph_with_shortest_latency(
                probe, self.engine.get_worker_waiting_time()
            )
            if nxt is None:
                break
            expected = self.engine.get_expected_latency(nxt)
            if expected > 0:
                res[nxt.worker_id] = res.get(nxt.worker_id, 0) + expected
            resolved = resolved | nxt.unit_indices
            probe.resolved_unit_subgraphs = frozenset(resolved)
            key = nxt
            guard += 1
        if res:
            self._reservations[job.job_id] = res

    def on_job_finished(self, job_id: int) -> None:
        self._reservations.pop(job_id, None)
