"""Scheduler interface (reference: band/scheduler/scheduler.h:11-29).

A scheduler inspects a job queue and returns (job, subgraph) dispatch
actions, removing the jobs it scheduled from the queue.  Schedulers are
pure decision logic against the EngineBase SPI, so they are testable
with a mock engine exactly like the reference's scheduler_test.cc."""

from __future__ import annotations

import abc
from typing import Deque, List

from ..common import Job, ScheduleAction, WorkerType
from ..runtime.engine_interface import EngineBase


class Scheduler(abc.ABC):
    worker_type: WorkerType = WorkerType.DEVICE_QUEUE
    needs_fallback_subgraphs: bool = False

    def __init__(self, engine: EngineBase, schedule_window_size: int = 1 << 30):
        self.engine = engine
        self.window = schedule_window_size

    @abc.abstractmethod
    def schedule(self, queue: Deque[Job]) -> List[ScheduleAction]:
        """Pop schedulable jobs from `queue`, return dispatch actions."""
