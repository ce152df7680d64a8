"""Shortest-expected-latency scheduler (reference:
band/scheduler/shortest_expected_latency_scheduler.cc:13-94).

Each round, every queued job (within the window) is priced by the best
(subgraph, worker) it could run next; the *most urgent* job — the one
whose best-case finish is furthest away — is dispatched first, and the
hypothetical worker waiting times are advanced.  Identical
(model, resolved-units) searches within one pass are deduplicated."""

from __future__ import annotations

from typing import Deque, Dict, List, Optional, Tuple

from ..common import Job, ScheduleAction, SubgraphKey, WorkerType
from .base import Scheduler


class ShortestExpectedLatencyScheduler(Scheduler):
    worker_type = WorkerType.DEVICE_QUEUE
    needs_fallback_subgraphs = True

    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        actions: List[ScheduleAction] = []
        waiting = dict(self.engine.get_worker_waiting_time())
        window = min(self.window, len(queue))
        for _ in range(window):
            cache: Dict[Tuple[int, frozenset], Tuple[Optional[SubgraphKey], int]] = {}
            best_job: Optional[Job] = None
            best_key: Optional[SubgraphKey] = None
            largest_shortest = -1
            for job in list(queue)[: self.window]:
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
            queue.remove(best_job)
            actions.append((best_job, best_key))
            expected = self.engine.get_expected_latency(best_key)
            if expected > 0:
                waiting[best_key.worker_id] = (
                    waiting.get(best_key.worker_id, 0) + expected
                )
        return actions
