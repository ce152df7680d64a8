"""Round-robin scheduler (reference:
band/scheduler/round_robin_scheduler.cc:7-30): for each idle worker,
dispatch the first queued job that has a valid subgraph on it."""

from __future__ import annotations

from typing import Deque, List

from ..common import Job, ScheduleAction, WorkerType
from .base import Scheduler


class RoundRobinScheduler(Scheduler):
    worker_type = WorkerType.DEVICE_QUEUE

    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        actions: List[ScheduleAction] = []
        for wid in self.engine.get_idle_workers():
            for job in list(queue):
                key = self.engine.get_largest_subgraph_key(job.model_id, wid)
                if key is not None and key.is_valid():
                    queue.remove(job)
                    actions.append((job, key))
                    break
        return actions
