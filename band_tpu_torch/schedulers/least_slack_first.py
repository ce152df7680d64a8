"""Least-slack-first scheduler (reference:
band/scheduler/least_slack_first_scheduler.cc).

Window sorted by slack = deadline - now - remaining expected latency
(:68-77); jobs already past their SLO are dropped before dispatch
(:41-47); dispatch to idle workers, advancing hypothetical waiting
times (:49-57)."""

from __future__ import annotations

from typing import Deque, List, Optional, Set

from ..common import Job, JobStatus, ScheduleAction, SubgraphKey, WorkerType, now_us
from .base import Scheduler


class LeastSlackFirstScheduler(Scheduler):
    worker_type = WorkerType.GLOBAL_QUEUE
    needs_fallback_subgraphs = True

    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        actions: List[ScheduleAction] = []
        waiting = dict(self.engine.get_worker_waiting_time())
        idle: Set[int] = set(self.engine.get_idle_workers())
        now = now_us()

        window = list(queue)[: self.window]

        # drop jobs that can no longer meet their SLO
        for job in list(window):
            if job.slo_us > 0 and now - job.enqueue_time > job.slo_us:
                queue.remove(job)
                window.remove(job)
                job.status = JobStatus.SLO_VIOLATION
                job.end_time = now
                self.engine.enqueue_finished_job(job)

        def slack(job: Job) -> int:
            if job.slo_us <= 0:
                return 1 << 62
            key, end = self.engine.get_subgraph_with_shortest_latency(
                job, waiting
            )
            remaining = (
                end if key is not None else 0
            )
            return job.slo_us - (now - job.enqueue_time) - remaining

        window.sort(key=slack)
        for job in window:
            if not idle:
                break
            key, _ = self.engine.get_subgraph_with_shortest_latency(
                job, waiting
            )
            if key is None or key.worker_id not in idle:
                continue
            queue.remove(job)
            idle.discard(key.worker_id)
            actions.append((job, key))
            expected = self.engine.get_expected_latency(key)
            if expected > 0:
                waiting[key.worker_id] = waiting.get(key.worker_id, 0) + expected
        return actions
