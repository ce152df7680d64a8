"""Fixed-worker schedulers (reference:
band/scheduler/fixed_worker_scheduler.cc:4-26 and
fixed_worker_global_queue_scheduler.cc).

Jobs go to their requested worker (explicit target_worker_id wins, else
the model's preassigned worker), always running the largest subgraph.
The global-queue variant waits for the worker to become idle before
dispatching — implemented here (the reference left it as a
BAND_NOT_IMPLEMENTED stub)."""

from __future__ import annotations

from typing import Deque, List

from ..common import Job, ScheduleAction, WorkerType
from .base import Scheduler


class FixedWorkerScheduler(Scheduler):
    worker_type = WorkerType.DEVICE_QUEUE

    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        actions: List[ScheduleAction] = []
        while queue:
            job = queue.popleft()
            wid = (
                job.target_worker_id
                if job.target_worker_id >= 0
                else self.engine.get_model_worker(job.model_id)
            )
            key = self.engine.get_largest_subgraph_key(job.model_id, wid)
            actions.append((job, key))
        return actions


class FixedWorkerGlobalQueueScheduler(Scheduler):
    worker_type = WorkerType.GLOBAL_QUEUE

    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        actions: List[ScheduleAction] = []
        idle = set(self.engine.get_idle_workers())
        remaining: List[Job] = []
        while queue:
            job = queue.popleft()
            wid = (
                job.target_worker_id
                if job.target_worker_id >= 0
                else self.engine.get_model_worker(job.model_id)
            )
            if wid in idle:
                key = self.engine.get_largest_subgraph_key(job.model_id, wid)
                actions.append((job, key))
                idle.discard(wid)
            else:
                remaining.append(job)
        queue.extend(remaining)
        return actions
