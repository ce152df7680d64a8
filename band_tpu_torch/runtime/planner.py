"""Planner: the scheduling thread.

Drains the request queue into per-scheduler local queues (SLO jobs to
queue 0, reference: band/planner.cc:295-320), invokes the schedulers,
applies SLO early-drop, splits multi-subgraph jobs into continuations
and dispatches to workers (reference: band/planner.cc:268-409).
Finished jobs land in a bounded record ring observed by Wait()
(reference: planner.h:21,144, planner.cc:155-210)."""

from __future__ import annotations

import collections
import itertools
import threading
import traceback
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)

from ..common import (
    Job,
    JobStatus,
    RequestCallback,
    SafeEvent,
    ScheduleAction,
    SchedulerType,
    SubgraphKey,
    now_us,
)
from ..config import PlannerConfig
from ..errors import ConfigError
from ..tracing.logger import log_error
from .engine_interface import EngineBase

NUM_FINISHED_RECORDS = 1000
# status-only retention (job_id -> JobStatus, a few bytes each) far
# beyond the full-record ring: a caller that enqueues a large burst and
# waits AFTER completions started must still see every status, even
# once the records themselves evicted (round-4 bench: the first ~250 of
# 3000 fast jobs finished and evicted before wait_all subscribed)
NUM_STATUS_RECORDS = 1_000_000


def make_scheduler(stype: SchedulerType, engine: EngineBase, window: int):
    from ..schedulers.fixed_worker import (
        FixedWorkerGlobalQueueScheduler,
        FixedWorkerScheduler,
    )
    from ..schedulers.heft import HEFTScheduler
    from ..schedulers.least_slack_first import LeastSlackFirstScheduler
    from ..schedulers.round_robin import RoundRobinScheduler
    from ..schedulers.shortest_expected_latency import (
        ShortestExpectedLatencyScheduler,
    )

    if stype == SchedulerType.FIXED_WORKER:
        return FixedWorkerScheduler(engine, window)
    if stype == SchedulerType.FIXED_WORKER_GLOBAL_QUEUE:
        return FixedWorkerGlobalQueueScheduler(engine, window)
    if stype == SchedulerType.ROUND_ROBIN:
        return RoundRobinScheduler(engine, window)
    if stype == SchedulerType.SHORTEST_EXPECTED_LATENCY:
        return ShortestExpectedLatencyScheduler(engine, window)
    if stype == SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME:
        return HEFTScheduler(engine, window, reserve=False)
    if stype == SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME_RESERVED:
        return HEFTScheduler(engine, window, reserve=True)
    if stype == SchedulerType.LEAST_SLACK_TIME_FIRST:
        return LeastSlackFirstScheduler(engine, window)
    raise ConfigError(f"unknown scheduler type {stype}")


class Planner:
    def __init__(self, engine: EngineBase, config: PlannerConfig):
        self.engine = engine
        self.config = config
        self.schedulers = [
            make_scheduler(s, engine, config.schedule_window_size)
            for s in config.schedulers
        ]
        # SLO-tagged jobs always go to the first scheduler's queue
        self.local_queues: List[Deque[Job]] = [
            collections.deque() for _ in self.schedulers
        ]
        self._requests: Deque[Job] = collections.deque()
        self._requests_lock = threading.Lock()
        # pending model purges: (model_id, done event), processed on the
        # planner thread so queue surgery never races the schedulers
        self._purges: List = []
        self._job_counter = itertools.count()
        self._safe_event = SafeEvent()

        self._finished_lock = threading.Condition()
        self._finished: "collections.OrderedDict[int, Job]" = collections.OrderedDict()
        # live wait() registrations: (pending id set, output dict)
        self._waiters: List[Tuple[set, Dict[int, JobStatus]]] = []
        # status-only history (see NUM_STATUS_RECORDS)
        self._statuses: "collections.OrderedDict[int, JobStatus]" = (
            collections.OrderedDict()
        )
        self._callbacks: Dict[int, RequestCallback] = {}
        self._callback_counter = itertools.count()
        self._execution_counts: Dict[int, int] = {}

        self._thread = threading.Thread(
            target=self._plan, name="band-planner", daemon=True
        )
        self._running = True
        self._thread.start()

    # ------------------------------------------------------------------
    def stop(self) -> None:
        self._running = False
        self._safe_event.terminate()
        self._thread.join(timeout=10)

    def add_callback(self, cb: RequestCallback) -> int:
        """Register an end-of-request callback; returns a handle for
        remove_callback (reference: c_api.h BandEngineSetOnEndRequest /
        BandEngineUnsetOnEndRequest)."""
        handle = next(self._callback_counter)
        self._callbacks[handle] = cb
        return handle

    def remove_callback(self, handle: int) -> bool:
        return self._callbacks.pop(handle, None) is not None

    # ------------------------------------------------------------------
    def enqueue_batch(
        self, jobs: Sequence[Job], push_front: bool = False
    ) -> List[int]:
        """Stamp ids/enqueue times, queue, wake the planner
        (reference: planner.cc:125-153)."""
        ids = []
        with self._requests_lock:
            now = now_us()
            stamped = []
            for job in jobs:
                if job.job_id < 0:
                    job.job_id = next(self._job_counter)
                    job.enqueue_time = now
                stamped.append(job)
                ids.append(job.job_id)
            if push_front:
                self._requests.extendleft(reversed(stamped))
            else:
                self._requests.extend(stamped)
        self._safe_event.notify()
        return ids

    def trigger(self) -> None:
        self._safe_event.notify()

    def purge_model(
        self, model_id: int, finalize=None, timeout: float = 10.0
    ) -> bool:
        """Fail every queued job of a model with ENQUEUE_FAILED (used by
        Engine.unregister_model); blocks until the planner thread has
        done the queue surgery.  `finalize`, if given, runs on the
        planner thread right after the purge (between scheduling passes,
        so record teardown cannot race a scheduler mid-pass); its bool
        result is returned."""
        ev = threading.Event()
        holder = {"done": False}
        with self._requests_lock:
            self._purges.append((model_id, finalize, holder, ev))
        self._safe_event.notify()
        ev.wait(timeout)
        return holder["done"]

    # ------------------------------------------------------------------
    def wait(self, job_ids: Sequence[int], timeout: float = 60.0) -> Dict[int, JobStatus]:
        """Block until all job ids are finished (reference:
        planner.cc:155-173).

        Statuses are collected INCREMENTALLY: the finished ring holds
        NUM_FINISHED_RECORDS (reference parity), so a wait over more
        ids than the ring can never observe them all simultaneously —
        the round-4 bench waited on 8000 ids and timed out with every
        thread idle.  The waiter registers its pending set and
        enqueue_finished_job delivers each status DIRECTLY under the
        ring lock, so even a flood of completions that cycles the ring
        between waiter wakes (lock handoff is not fair) cannot lose
        one."""
        import time as _time

        deadline = _time.monotonic() + timeout
        pending = set(job_ids)
        out: Dict[int, JobStatus] = {}
        reg = (pending, out)
        with self._finished_lock:
            # harvest anything already finished, then subscribe
            for j in pending.intersection(self._statuses):
                out[j] = self._statuses[j]
            for j in out:
                pending.discard(j)
            self._waiters.append(reg)
            try:
                while pending:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        break
                    self._finished_lock.wait(timeout=min(remaining, 0.5))
            finally:
                self._waiters.remove(reg)
        return out

    def get_finished_job(self, job_id: int) -> Optional[Job]:
        with self._finished_lock:
            return self._finished.get(job_id)

    def discard_finished(self, job_ids: Sequence[int]) -> None:
        """Drop finished records a caller will never fetch (e.g. a
        streaming front-end whose client disconnected mid-stream) so
        they don't sit in the ring until evicted."""
        with self._finished_lock:
            for jid in job_ids:
                self._finished.pop(jid, None)
                self._statuses.pop(jid, None)

    def enqueue_finished_job(self, job: Job) -> None:
        """Record ring + wake waiters + fire end-of-request callbacks
        (reference: planner.cc:184-210)."""
        with self._finished_lock:
            self._finished[job.job_id] = job
            while len(self._finished) > NUM_FINISHED_RECORDS:
                self._finished.popitem(last=False)
            self._execution_counts[job.model_id] = (
                self._execution_counts.get(job.model_id, 0) + 1
            )
            self._statuses[job.job_id] = job.status
            while len(self._statuses) > NUM_STATUS_RECORDS:
                self._statuses.popitem(last=False)
            # deliver to registered waiters directly (see wait):
            # eviction from the ring can then never lose a status
            for pending, out in self._waiters:
                if job.job_id in pending:
                    out[job.job_id] = job.status
                    pending.discard(job.job_id)
            self._finished_lock.notify_all()
        for scheduler in self.schedulers:
            on_fin = getattr(scheduler, "on_job_finished", None)
            if on_fin:
                on_fin(job.job_id)
        if job.require_callback:
            for cb in list(self._callbacks.values()):
                try:
                    cb(job.job_id, job.status)
                except Exception:
                    # user callbacks must never take down the calling
                    # worker/planner thread (finished-job notification is
                    # fired from both)
                    log_error(
                        "end-of-request callback raised for job %d:\n%s",
                        job.job_id, traceback.format_exc(),
                    )

    def get_model_execution_counts(self) -> Dict[int, int]:
        return dict(self._execution_counts)

    # ------------------------------------------------------------------
    def _copy_to_local_queues(self) -> None:
        """SLO jobs -> queue 0, rest -> last queue
        (reference: planner.cc:295-320)."""
        with self._requests_lock:
            jobs = list(self._requests)
            self._requests.clear()
        if not jobs:
            return
        # jobs for models that vanished mid-flight (unregister raced a
        # continuation re-enqueue) fail here instead of crashing a
        # scheduler on an unknown model id
        live = []
        for job in jobs:
            if not self.engine.has_model(job.model_id):
                job.status = JobStatus.ENQUEUE_FAILED
                job.end_time = now_us()
                self.enqueue_finished_job(job)
            else:
                live.append(job)
        jobs = live
        if len(self.local_queues) == 1:
            self.local_queues[0].extend(jobs)
            return
        for job in jobs:
            if job.slo_us > 0:
                self.local_queues[0].append(job)
            else:
                self.local_queues[-1].append(job)

    def _process_purges(self) -> None:
        with self._requests_lock:
            if not self._purges:
                return
            purges, self._purges = self._purges, []
        for model_id, finalize, holder, ev in purges:
            for queue in self.local_queues:
                dropped = [j for j in queue if j.model_id == model_id]
                if dropped:
                    kept = [j for j in queue if j.model_id != model_id]
                    queue.clear()
                    queue.extend(kept)
                for job in dropped:
                    job.status = JobStatus.ENQUEUE_FAILED
                    job.end_time = now_us()
                    self.enqueue_finished_job(job)
            holder["done"] = finalize() if finalize is not None else True
            ev.set()

    def _plan(self) -> None:
        """Main loop (reference: planner.cc:268-293)."""
        # pin the planner thread when configured (reference:
        # `planner_cpu_masks` + planner.cc:22-27 UpdateThread)
        if self.config.cpu_mask:
            from ..device import cpu as cpu_dev

            mask = cpu_dev.resolve_configured_mask(self.config.cpu_mask)
            if mask is not None:
                cpu_dev.set_thread_affinity(mask)
        while True:
            # wake periodically while jobs are pending so SLO shedding
            # (planner early-drop, LSF in-scheduler drops) runs even
            # when no worker/enqueue trigger arrives — e.g. every
            # eligible worker is quarantined and jobs would otherwise
            # strand in the local queues past their deadlines
            pending = any(self.local_queues) or bool(self._requests)
            if self._safe_event.wait(timeout=0.01 if pending else None):
                return
            if not self._running:
                return
            self._copy_to_local_queues()
            self._process_purges()
            for scheduler, queue in zip(self.schedulers, self.local_queues):
                if not queue:
                    continue
                # schedulers only pop from their window, so the rescue
                # snapshot need only cover that prefix
                window = min(getattr(scheduler, "window", 1 << 30),
                             len(queue))
                before = list(itertools.islice(queue, window))
                actions = []
                try:
                    actions = scheduler.schedule(queue)
                except Exception:
                    # never kill the planner thread: a scheduler can
                    # raise mid-pass when a model vanishes under it (an
                    # unregister race). Jobs it already popped are in
                    # neither the queue nor any worker — rescue them:
                    # requeue live-model ones, fail vanished-model ones,
                    # and drop any reservations they booked.
                    log_error(
                        "scheduler pass error:\n%s", traceback.format_exc()
                    )
                    still_queued = {id(j) for j in queue}
                    on_fin = getattr(scheduler, "on_job_finished", None)
                    # reversed so appendleft preserves FIFO order
                    for job in reversed(before):
                        if id(job) in still_queued:
                            continue
                        if on_fin:
                            on_fin(job.job_id)
                        if self.engine.has_model(job.model_id):
                            queue.appendleft(job)
                        else:
                            self._fail_job(job)
                    for job in [
                        j for j in queue
                        if not self.engine.has_model(j.model_id)
                    ]:
                        queue.remove(job)
                        self._fail_job(job)
                self._enqueue_to_workers(actions)

    def _fail_job(self, job: Job) -> None:
        job.status = JobStatus.ENQUEUE_FAILED
        job.end_time = now_us()
        self.enqueue_finished_job(job)

    def _enqueue_to_workers(self, actions: Sequence[ScheduleAction]) -> None:
        """SLO early-drop + continuation split + dispatch
        (reference: planner.cc:322-409).  Per-action errors (a model
        vanishing between pricing and dispatch) fail that job only."""
        for job, key in actions:
            try:
                self._enqueue_one(job, key)
            except Exception:
                log_error(
                    "dispatch error for job %d:\n%s",
                    job.job_id, traceback.format_exc(),
                )
                self._fail_job(job)

    def _enqueue_one(self, job: Job, key: Optional[SubgraphKey]) -> None:
        if key is None or not key.is_valid():
            self._fail_job(job)
            return
        # SLO violation check before dispatch (planner.cc:338-347) —
        # priced at the job's stacked-window bucket cost: a job riding a
        # B-wide batched dispatch finishes when the whole bucket does
        if job.slo_us > 0:
            expected = max(
                self.engine.get_expected_latency(key, job.batch_size), 0
            )
            if now_us() - job.enqueue_time + expected > job.slo_us:
                job.status = JobStatus.SLO_VIOLATION
                job.end_time = now_us()
                self.enqueue_finished_job(job)
                return
        job.subgraph_key = key
        job.expected_execution_time = max(
            self.engine.get_expected_latency(key, job.batch_size), 0
        )
        self._update_job_schedule_status(job, key)
        if not self.engine.dispatch(job):
            # worker rejected (busy global-queue worker / throttled):
            # give the job back to the planner front
            job.subgraph_key = SubgraphKey()
            job.following_jobs = []
            self.enqueue_batch([job], push_front=True)

    def _update_job_schedule_status(self, job: Job, key: SubgraphKey) -> None:
        """Split the remainder of a partial-model job into a following job
        (reference: planner.cc:385-409)."""
        resolved = job.resolved_unit_subgraphs | key.unit_indices
        if self.engine.is_end_of_model(key, job.resolved_unit_subgraphs):
            job.following_jobs = []
            return
        follow = Job(
            model_id=job.model_id,
            job_id=job.job_id,
            enqueue_time=job.enqueue_time,
            slo_us=job.slo_us,
            target_worker_id=job.target_worker_id,
            input_handle=job.input_handle,
            output_handle=job.output_handle,
            require_callback=job.require_callback,
        )
        follow.resolved_unit_subgraphs = frozenset(resolved)
        job.following_jobs = [follow]
