"""Workers: one host dispatch thread per CUDA card (or the host CPU).

Re-implements the reference worker model (band/worker.{h,cc},
band/worker_device_queue.cc, band/worker_global_queue.cc) with the blocking invoke replaced by
asynchronous launches plus a completion wait on a separate retire
thread, so the waiting-time estimate stays truthful on an asynchronous
device:

 * DeviceQueueWorker — per-worker FIFO; waiting time = sum of expected
   latencies of queued jobs plus the remaining time of the in-flight
   job (reference: worker_device_queue.cc:44-69)
 * GlobalQueueWorker — at most one in-flight dispatch; enqueue-ready
   only while idle (reference: worker_global_queue.cc:25-53, 125-164)

Completion: the dispatch thread records a CUDA event on the stream it
launched on (PyTorch's current stream is per thread) right after a
window's launches, and the retire thread synchronises on that event,
not on its own current stream.  On a CPU worker the launches complete
before the dispatch returns and there is no event.

Co-dispatch: a DeviceQueueWorker with ``spec.co_dispatch > 1`` pops the
head window plus the following distinct-subgraph windows and, when
their mix's combined program is ready, serves them as one dispatch (a
CUDA graph replay on a card).  Each window keeps its own in-flight
record, ``(jobs, outs, event, share)``, all on the one event recorded
after the replay; ``share`` is the window's part of the expected cost,
and the latency update charges the window that part.

Counterpart: band_tpu/runtime/worker.py.

On device error the worker throttles, re-enqueues its queue to the
planner front and polls availability (reference: worker.cc:101-110,
worker_device_queue.cc:110-125)."""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
import time
import traceback
from typing import Deque, Dict, List, Optional

from ..common import Job, JobStatus, bucket_of, now_us, subgraph_sort_key
from ..config import WorkerSpec
from ..tracing.logger import log_error
from ..errors import ExecutionError
from ..tracing.job_tracer import tracer
from .engine_interface import EngineBase

LARGE_WAITING_TIME = 1 << 62


class Worker:
    """Base worker thread (reference: band/worker.h:17-80)."""

    def __init__(self, engine: EngineBase, worker_id: int, spec: WorkerSpec):
        self.engine = engine
        self.worker_id = worker_id
        self.spec = spec
        self._cv = threading.Condition()
        self._kill = False
        self._kill_event = threading.Event()
        self._paused = False
        self._available = True
        # device-recovery probe cadence (reference: band/config.h:53);
        # spec value 0 inherits the pool default of 30 s — the engine
        # overwrites this with the configured pool value at startup
        self._avail_check_ms = spec.availability_check_interval_ms or 30_000
        self._recovering = False
        # set by resource-aware policies (thermal/HBM pressure); the
        # worker reports unavailable so schedulers route around it
        self._resource_throttled = False
        self._thread: Optional[threading.Thread] = None
        self._retire_thread: Optional[threading.Thread] = None
        # dispatched-but-unretired records flow to the retirement
        # thread through here; replaced wholesale on rejoin so a
        # reviving stale-generation thread can never steal new records
        self._retire_q: "queue_mod.Queue" = queue_mod.Queue()
        self._inflight_count = 0  # dispatch backpressure (<= depth)
        self._idle_cv = threading.Condition()
        self._dispatching = False
        # jobs dispatched but not yet retired (waiting-time estimates)
        self._inflight_jobs: List[Job] = []
        # (generation, monotonic) stamps while a dispatch (input copy +
        # launch) / a retirement (completion ack) is executing; the
        # engine watchdog quarantines the worker if either blocks past
        # spec.stuck_timeout_ms.  Generation-tagged so a stale thread
        # reviving after a rejoin can neither clear the new
        # generation's stamp nor leave a phantom stamp the watchdog
        # would read as a wedge (busy_for ignores old-generation tags).
        self._busy_since: Optional[tuple] = None
        self._retire_busy_since: Optional[tuple] = None
        self._quarantined = False
        # dispatch-thread generation: bumped when a rejoin retires a
        # still-wedged thread and hands the loop to a fresh one
        self._gen = 0
        # >0 while a dispatch runs a (key, bucket) for the first time,
        # which may build the kernels with nvcc (set by
        # Engine._invoke_flagged); the watchdog must not mistake a long
        # build for a wedged dispatch
        self._compiling = 0

    def _max_depth(self) -> int:
        return self.spec.dispatch_depth

    # --- lifecycle ---
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._work, name=f"band-worker-{self.worker_id}",
            daemon=True,
        )
        self._retire_thread = threading.Thread(
            target=self._retire_loop, args=(self._retire_q,),
            name=f"band-retire-{self.worker_id}", daemon=True,
        )
        self._thread.start()
        self._retire_thread.start()

    def stop(self) -> None:
        self._kill_event.set()
        with self._cv:
            self._kill = True
            self._cv.notify_all()
        self._retire_q.put(None)
        if self._thread:
            self._thread.join(timeout=10)
        if self._retire_thread:
            self._retire_thread.join(timeout=10)

    def pause(self) -> None:
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def wait_until_idle(self, timeout: float = 30.0) -> bool:
        """Block until queue drained and nothing is processing
        (reference: Worker::Wait)."""
        deadline = time.monotonic() + timeout
        with self._idle_cv:
            while (self.has_job() or self._processing) and (
                time.monotonic() < deadline
            ):
                self._idle_cv.wait(timeout=0.05)
            return not (self.has_job() or self._processing)

    def is_available(self) -> bool:
        return (
            self._available
            and not self._quarantined
            and not self._resource_throttled
        )

    @property
    def _processing(self) -> bool:
        """True while a dispatch is assembling/launching or any window
        is dispatched-but-unretired (schedulers and wait_until_idle
        read this)."""
        return self._dispatching or self._inflight_count > 0

    # --- failure detection (engine watchdog) ---
    def busy_for(self) -> float:
        """Seconds the current dispatch or retirement has been
        executing (0 when between work units); the two run on separate
        threads (pipelined serving), either can wedge."""
        now = time.monotonic()
        out = 0.0
        gen = self._gen
        for st in (self._busy_since, self._retire_busy_since):
            if st is not None and st[0] == gen:
                out = max(out, now - st[1])
        return out

    def quarantine(self, recover: bool = True) -> List[Job]:
        """Sideline a wedged worker: fail its in-flight jobs so
        requesters unblock, hand queued jobs back for rescheduling, and
        report unavailable to every scheduler.  The wedged thread may
        revive later; retirement guards (_fail_jobs/_complete status
        checks) keep it from double-finishing anything.

        With ``recover`` (the default), the worker gets the same
        availability re-probing the device-error path has (reference:
        worker.cc:101-110; round 3's quarantine was permanent — one
        transient transport hang halved a 2-worker deployment until
        restart): a side thread probes the wedged subgraph every
        availability_check_interval_ms and, on success, returns the
        worker to service with a fresh dispatch thread."""
        self._quarantined = True
        requeue = self._requeue_all()
        with self._cv:
            inflight = list(self._inflight_jobs)
        probe_key = next(
            (
                j.subgraph_key
                for j in inflight + requeue
                if j.subgraph_key.is_valid()
            ),
            None,
        )
        self._fail_jobs(inflight)
        for j in requeue:
            j.subgraph_key = type(j.subgraph_key)()  # reassign elsewhere
            j.status = JobStatus.QUEUED
            j.invoke_time = 0
        if recover:
            self._start_quarantine_recovery(probe_key)
        return requeue

    def _start_quarantine_recovery(self, probe_key) -> None:
        def _probe_loop():
            interval = max(self._avail_check_ms, 1) / 1000.0
            while not self._kill_event.wait(interval):
                key = probe_key
                if key is None or not key.is_valid():
                    key = self.engine.probe_key_for_worker(self.worker_id)
                if key is None:
                    continue
                if self.engine.probe_subgraph(key):
                    self._rejoin()
                    return

        threading.Thread(
            target=_probe_loop,
            name=f"band-rejoin-{self.worker_id}",
            daemon=True,
        ).start()

    def _rejoin(self) -> None:
        """Return a quarantined worker to service.  The old dispatch
        thread may still be wedged inside a transfer, so the generation
        counter retires it (it exits at its next loop turn without
        dequeuing anything) and a fresh dispatch thread takes over;
        zombie dispatch state is cleared first."""
        old_q = self._retire_q
        with self._cv:
            self._gen += 1
            self._inflight_jobs = []
            self._inflight_count = 0
            self._dispatching = False
            # fresh generation-bound queue: a reviving stale retire
            # thread holds the old object and can't steal new records
            self._retire_q = queue_mod.Queue()
            self._reset_dispatch_state()
            self._cv.notify_all()
        old_q.put(None)  # unblock the old retire thread when it revives
        with self._idle_cv:
            self._idle_cv.notify_all()
        self._busy_since = None
        self._retire_busy_since = None
        self.start()  # fresh dispatch + retire threads
        self._quarantined = False
        self._available = True
        self.engine.trigger()

    def _reset_dispatch_state(self) -> None:
        """Hook: clear per-flavor dispatch state a wedged thread may
        have left behind (called under _cv by _rejoin)."""

    def set_resource_throttled(self, throttled: bool) -> None:
        if throttled != self._resource_throttled:
            self._resource_throttled = throttled
            if not throttled:
                with self._cv:
                    self._cv.notify_all()

    # --- queue interface (overridden) ---
    def has_jobs_for(self, model_id: int) -> bool:
        """True while any queued or in-flight job belongs to the model
        (used by Engine.unregister_model to drain safely)."""
        with self._cv:
            return any(j.model_id == model_id for j in self._inflight_jobs)

    def enqueue_job(self, job: Job) -> bool:
        raise NotImplementedError

    def has_job(self) -> bool:
        raise NotImplementedError

    def get_waiting_time(self) -> int:
        raise NotImplementedError

    def is_enqueue_ready(self) -> bool:
        return self.is_available()

    def _dequeue(self) -> Optional[Job]:
        raise NotImplementedError

    def _dequeue_many(self) -> List[Job]:
        job = self._dequeue()
        return [job] if job is not None else []

    def _dequeue_groups(self) -> List[List[Job]]:
        """One or more dispatch windows popped together (called under
        _cv).  The base worker never fuses; DeviceQueueWorker may
        return several distinct-subgraph windows when spec.co_dispatch
        allows and the combined program is ready."""
        jobs = self._dequeue_many()
        return [jobs] if jobs else []

    def _requeue_all(self) -> List[Job]:
        raise NotImplementedError

    # --- main loops (reference: Worker::Work, worker.cc:222-323) ---
    # Unlike the reference's strictly blocking loop, dispatch and
    # retirement run on SEPARATE threads: up to `dispatch_depth` work
    # units stay in flight, the dispatch thread never blocks on a
    # completion ack, and the retirement thread drains whatever has
    # accumulated with ONE ack per drain (device programs execute in
    # order, so readiness of the newest record implies the older ones
    # finished).  Round-4 thread sampling showed the single-threaded
    # loop spending 77% of its time inside the retirement ack on a
    # high-RTT transport — every ack stalled dispatch for a full round
    # trip and drained the device.
    def _work(self) -> None:
        # pin the dispatch thread to the configured core set (reference:
        # Worker::UpdateWorkerThread, worker.cc:61-91 — the reference pins
        # even accelerator workers' host threads this way)
        if self.spec.cpu_mask:
            from ..device import cpu as cpu_dev

            mask = cpu_dev.resolve_configured_mask(self.spec.cpu_mask)
            if mask is not None:
                cpu_dev.set_thread_affinity(mask)
        depth = max(self._max_depth(), 1)
        gen = self._gen
        q = self._retire_q
        while True:
            with self._cv:
                while (self._kill is False and self._gen == gen) and (
                    self._paused
                    or not self.has_job()
                    or self._inflight_count >= depth
                ):
                    self._cv.wait(timeout=0.1)
                if self._gen != gen:
                    # retired by a rejoin: a fresh thread owns the loop
                    # now (in-flight records were failed at quarantine)
                    return
                if self._kill:
                    q.put(None)
                    return
                groups = self._dequeue_groups()
                jobs = [j for g in groups for j in g]
                # visible to has_jobs_for/waiting-time from the moment
                # they leave the queue (no blind window during the
                # input-copy + launch phase)
                self._inflight_jobs.extend(jobs)
                if jobs:
                    self._dispatching = True
            if not jobs:
                continue
            try:
                self._busy_since = (gen, time.monotonic())
                if len(groups) == 1:
                    recs = self._dispatch(jobs, gen)
                else:
                    # fused multi-window dispatch: one replay, one
                    # in-flight record per window (retired in order)
                    recs = self._dispatch_multi(groups, gen)
                if recs:
                    with self._cv:
                        if self._gen == gen:
                            self._inflight_count += len(recs)
                            for rec in recs:
                                q.put(rec)
                        # else: a rejoin retired this generation while
                        # the dispatch was in flight — its jobs were
                        # already failed at quarantine; leaking the +1
                        # into the fresh counter would block dispatch
                        # forever (ADVICE r4 high)
            except Exception:  # safety net: never kill the worker thread
                log_error(
                    "worker %d dispatch error:\n%s",
                    self.worker_id, traceback.format_exc(),
                )
                if self._gen == gen:
                    self._fail_jobs(jobs)
            finally:
                st = self._busy_since
                if st is not None and st[0] == gen:
                    self._busy_since = None
                with self._idle_cv:
                    if self._gen == gen:
                        self._dispatching = False
                    self._idle_cv.notify_all()

    def _retire_loop(self, q: "queue_mod.Queue") -> None:
        """Retirement thread: drain dispatched records, observe
        completion once per drained batch, retire in FIFO order.  The
        queue object is generation-bound (a rejoin swaps in a fresh
        one), so a reviving stale thread exits without touching new
        records."""
        gen = self._gen
        while True:
            rec = q.get()
            if self._gen != gen:
                return
            if rec is None:
                # kill: retire whatever was dispatched before the
                # sentinel so shutdown doesn't strand finished windows
                recs = []
                while True:
                    try:
                        r2 = q.get_nowait()
                    except queue_mod.Empty:
                        break
                    if r2 is not None:
                        recs.append(r2)
                if recs:
                    try:
                        self._finish_window(recs, gen)
                    except Exception:
                        for r in recs:
                            self._fail_jobs(r[0])
                return
            recs = [rec]
            stop = False
            while True:
                try:
                    r2 = q.get_nowait()
                except queue_mod.Empty:
                    break
                if r2 is None:
                    stop = True
                    break
                recs.append(r2)
            try:
                self._retire_busy_since = (gen, time.monotonic())
                self._finish_window(recs, gen)
            except Exception:
                log_error(
                    "worker %d retire error:\n%s",
                    self.worker_id, traceback.format_exc(),
                )
                if self._gen == gen:
                    for r in recs:
                        self._fail_jobs(r[0])
            finally:
                st = self._retire_busy_since
                if st is not None and st[0] == gen:
                    self._retire_busy_since = None
                with self._cv:
                    if self._gen == gen:
                        # a stale thread decrementing the fresh counter
                        # would push it negative and un-gate dispatch
                        # past the depth limit (ADVICE r4 high)
                        self._inflight_count -= len(recs)
                        self._cv.notify_all()
                with self._idle_cv:
                    self._idle_cv.notify_all()
                if self._gen == gen and self._inflight_count <= 0:
                    self.engine.trigger()
            if stop or self._gen != gen:
                return

    def _drop_inflight(self, jobs: List[Job]) -> None:
        with self._cv:
            self._inflight_jobs = [
                j for j in self._inflight_jobs if j not in jobs
            ]

    def _fail_jobs(self, jobs: List[Job]) -> None:
        """Error-path retirement that never double-finishes: jobs a
        partial _finish already completed (terminal status, or handed
        off as a continuation) are left alone."""
        for j in jobs:
            if j.status != JobStatus.QUEUED or j.retired:
                continue
            j.status = JobStatus.INVOKE_FAILURE
            j.end_time = now_us()
            self.engine.enqueue_finished_job(j)
        self._drop_inflight(jobs)

    def _dispatch(self, jobs: List[Job], gen: Optional[int] = None
                  ) -> List[tuple]:
        """Assemble inputs and launch one window (no completion wait).
        Returns its in-flight record in a list, or [] if the error paths
        consumed the jobs.  The caller has already marked `jobs`
        in-flight."""
        key = jobs[0].subgraph_key

        def launch():
            inputs_list = [
                self.engine.try_copy_input_tensors(j) for j in jobs
            ]
            self._begin(jobs)
            if len(jobs) == 1:
                outs = [self.engine.invoke(key, inputs_list[0])]
            else:
                outs = self.engine.invoke_batched(key, inputs_list)
            # recorded on this (the dispatch) thread's current stream,
            # the one the window was launched on
            return [(jobs, outs,
                     self.engine.record_completion(self.worker_id))]

        return self._guarded(jobs, gen, launch)

    def _dispatch_multi(
        self, groups: List[List[Job]], gen: Optional[int] = None
    ) -> List[tuple]:
        """Fused dispatch: several distinct-subgraph windows as ONE
        dispatch (engine.invoke_multi), one in-flight record per window,
        all on the one event recorded after it.  Each record carries the
        window's share of the combined program's expected cost so the
        retirement-side EMA update attributes the measured latency per
        subgraph instead of charging every key the full combined time."""
        jobs = [j for g in groups for j in g]
        sig = tuple((g[0].subgraph_key, bucket_of(len(g))) for g in groups)

        def launch():
            inputs_groups = [
                [self.engine.try_copy_input_tensors(j) for j in g]
                for g in groups
            ]
            self._begin(jobs)
            outs_groups = self.engine.invoke_multi(sig, inputs_groups)
            event = self.engine.record_completion(self.worker_id)
            exp = [
                max(self.engine.get_expected_latency(k, b), 1)
                for k, b in sig
            ]
            tot = float(sum(exp)) or 1.0
            return [
                (g, outs, event, e / tot)
                for g, outs, e in zip(groups, outs_groups, exp)
            ]

        return self._guarded(jobs, gen, launch)

    @staticmethod
    def _begin(jobs: List[Job]) -> None:
        start = now_us()
        for j in jobs:
            j.invoke_time = start
            tracer().begin_subgraph(j)

    def _guarded(self, jobs: List[Job], gen: Optional[int],
                 launch) -> List[tuple]:
        """Run ``launch`` (inputs, launch, in-flight records) and return
        its records; on an error consume ``jobs`` and return [].  `gen`
        is the calling thread's dispatch generation: error paths from a
        stale (pre-rejoin) thread must not resurrect jobs that
        quarantine already failed, nor mutate fresh-generation dispatch
        state."""
        try:
            return launch()
        except ExecutionError:
            for j in jobs:
                tracer().end_subgraph(j)
            if gen is not None and self._gen != gen:
                return []  # stale thread: jobs already failed at quarantine
            self._drop_inflight(jobs)
            self._handle_device_error(jobs[0])
            for j in jobs[1:]:
                j.subgraph_key = type(j.subgraph_key)()
                j.status = JobStatus.QUEUED
                j.invoke_time = 0
                self.engine.enqueue_batch([j], push_front=True)
            self._on_dispatch_consumed(jobs, gen)
            return []
        except Exception:
            log_error("worker %d dispatch failed:\n%s", self.worker_id,
                      traceback.format_exc())
            if gen is not None and self._gen != gen:
                return []  # stale thread: jobs already failed at quarantine
            self._drop_inflight(jobs)
            for j in jobs:
                j.status = JobStatus.INVOKE_FAILURE
                j.end_time = now_us()
                tracer().end_subgraph(j)
                self.engine.enqueue_finished_job(j)
            self._on_dispatch_consumed(jobs, gen)
            return []

    def _on_dispatch_consumed(
        self, jobs: List[Job], gen: Optional[int] = None
    ) -> None:
        """Hook: an error path consumed dequeued jobs without an
        in-flight record (so _finish will never run for them)."""

    @staticmethod
    def _wait_done(rec) -> None:
        """Block until the record's launches have completed on the device
        (its event; None when they ran synchronously on the host)."""
        if rec[2] is not None:
            rec[2].synchronize()

    def _finish_window(self, recs, gen: Optional[int] = None) -> None:
        """Retire several in-flight work units, blocking only on the
        newest (in-order execution on one stream makes the older ones
        ready too).  A failure retiring one record must not strand the
        others (the caller already cleared its deque), so each
        retirement is individually guarded."""
        ready_hint = False
        if len(recs) > 1:
            try:
                self._wait_done(recs[-1])
                ready_hint = True
            except Exception:
                # a program in the window failed: fall back to
                # per-record retirement so errors stay isolated
                ready_hint = False
        for rec in recs:
            try:
                self._finish(rec, ready_hint=ready_hint, gen=gen)
            except Exception:
                log_error(
                    "worker %d retire error:\n%s",
                    self.worker_id, traceback.format_exc(),
                )
                if gen is None or self._gen == gen:
                    self._fail_jobs(rec[0])

    def _finish(
        self, rec, ready_hint: bool = False, gen: Optional[int] = None
    ) -> None:
        """Retire one in-flight work unit: observe completion, update
        the cost model, hand off outputs/continuations.  Records from a
        fused dispatch carry a fourth element, the window's share of the
        combined program's expected cost, which the latency update
        charges instead of the whole measured time."""
        jobs, outputs_list = rec[0], rec[1]
        share = rec[3] if len(rec) > 3 else 1.0
        key = jobs[0].subgraph_key
        try:
            if not ready_hint:
                self._wait_done(rec)
        except Exception:
            for j in jobs:
                tracer().end_subgraph(j)
                if j.status != JobStatus.QUEUED or j.retired:
                    continue  # already decided (e.g. quarantine failed it)
                j.status = JobStatus.INVOKE_FAILURE
                j.end_time = now_us()
                self.engine.enqueue_finished_job(j)
            self._drop_inflight(jobs)
            return
        end = now_us()
        latency = end - jobs[0].invoke_time
        self.engine.update_latency(
            key, max(int(latency * share), 1), batch=len(jobs)
        )
        for j, outs in zip(jobs, outputs_list):
            j.end_time = end
            j.profiled_execution_time = latency
            tracer().end_subgraph(j)
            self._complete(j, outs)
        self._drop_inflight(jobs)

    def _complete(self, job: Job, outputs) -> None:
        if job.status != JobStatus.QUEUED or job.retired:
            # already decided elsewhere (e.g. quarantine failed it while
            # this thread was wedged in a transfer): don't double-finish
            return
        try:
            if job.following_jobs:
                # pipeline continuation: hand boundary activations to the
                # next hop
                self.engine.try_copy_output_tensors(job, outputs)
                for fj in job.following_jobs:
                    fj.activations.update(job.activations)
                self.engine.enqueue_batch(
                    job.following_jobs, push_front=True
                )
                job.retired = True  # lives on as the continuation
            else:
                self.engine.try_copy_output_tensors(job, outputs)
                job.status = JobStatus.SUCCESS
                self.engine.enqueue_finished_job(job)
        except Exception:
            # e.g. the model vanished under a timed-out unregister drain:
            # fail the job rather than killing the worker thread
            log_error(
                "worker %d completion error for job %d:\n%s",
                self.worker_id, job.job_id, traceback.format_exc(),
            )
            job.status = JobStatus.INVOKE_FAILURE
            job.end_time = now_us()
            self.engine.enqueue_finished_job(job)

    def _handle_device_error(self, job: Job) -> None:
        """Report unavailable + give jobs back to the planner + start
        re-probing the failed subgraph (reference: worker.cc:101-110,
        worker_device_queue.cc:110-125)."""
        failed_key = job.subgraph_key
        jobs = [job] + self._requeue_all()
        for j in jobs:
            j.subgraph_key = type(j.subgraph_key)()  # reset assignment
            j.status = JobStatus.QUEUED
            # a stale dispatch stamp would make the retried job look
            # almost-finished to waiting-time estimates
            j.invoke_time = 0
        self.engine.enqueue_batch(jobs, push_front=True)
        self._start_recovery(failed_key)

    def _start_recovery(self, failed_key) -> None:
        """Reference parity with Worker::WaitUntilDeviceAvailable
        (band/worker.cc:101-110): the worker reports unavailable (so
        latency-aware schedulers see LARGE_WAITING_TIME and route
        around it) and re-invokes the failed subgraph every
        ``availability_check_interval_ms`` until a probe succeeds.

        Unlike the reference — which parks the (blocking) worker thread
        in the poll loop — the probe runs on a side thread, keeping the
        dispatch thread responsive for pause/stop and out of the
        stuck-dispatch watchdog's way."""
        with self._cv:
            if self._recovering or self._quarantined:
                return
            self._recovering = True
            self._available = False

        def _probe_loop():
            try:
                interval = max(self._avail_check_ms, 1) / 1000.0
                while not self._kill_event.wait(interval):
                    if self._quarantined:
                        return
                    if self.engine.probe_subgraph(failed_key):
                        self._available = True
                        with self._cv:
                            self._cv.notify_all()
                        self.engine.trigger()
                        return
            finally:
                with self._cv:
                    self._recovering = False

        threading.Thread(
            target=_probe_loop,
            name=f"band-recover-{self.worker_id}",
            daemon=True,
        ).start()


class DeviceQueueWorker(Worker):
    """Per-worker FIFO queue (reference: band/worker_device_queue.cc)."""

    def __init__(self, engine: EngineBase, worker_id: int, spec: WorkerSpec):
        super().__init__(engine, worker_id, spec)
        self._queue: Deque[Job] = collections.deque()
        self._current: Optional[Job] = None

    def enqueue_job(self, job: Job) -> bool:
        if not job.subgraph_key.is_valid():
            return False
        with self._cv:
            self._queue.append(job)
            self._cv.notify_all()
        return True

    def has_job(self) -> bool:
        return bool(self._queue)

    def has_jobs_for(self, model_id: int) -> bool:
        with self._cv:
            return any(
                j.model_id == model_id for j in self._inflight_jobs
            ) or any(j.model_id == model_id for j in self._queue)

    def _dequeue(self) -> Optional[Job]:
        if not self._queue:
            return None
        self._current = self._queue.popleft()
        return self._current

    def _dequeue_many(self) -> List[Job]:
        """Pop the head job plus up to max_batch-1 queued jobs with the
        same subgraph key (continuous batching window).  While the
        key's buckets are still warming in the background, the window
        is capped at the largest bucket that has run."""
        job = self._dequeue()
        if job is None:
            return []
        jobs = [job]
        limit = max(
            min(
                self.spec.max_batch,
                self.engine.ready_batch_limit(job.subgraph_key),
            ),
            1,
        )
        while (
            len(jobs) < limit
            and self._queue
            and self._queue[0].subgraph_key == job.subgraph_key
        ):
            jobs.append(self._queue.popleft())
        return jobs

    def _dequeue_groups(self) -> List[List[Job]]:
        """Head window plus, when spec.co_dispatch > 1, the following
        consecutive distinct-subgraph windows, fused into one dispatch
        IF the mix's combined program is ready (a miss may schedule a
        background build and dispatches the head window alone, so
        fusion never stalls serving on a capture).  Called under _cv,
        so peeking the deque is race-free."""
        first = self._dequeue_many()
        if not first:
            return []
        limit = self.spec.co_dispatch
        if limit <= 1 or not self._queue:
            return [first]

        # peek the next consecutive same-key runs without popping
        taken = {first[0].subgraph_key}
        runs = []  # (key, length) in queue order from the head
        idx = 0
        while len(runs) + 1 < limit and idx < len(self._queue):
            key = self._queue[idx].subgraph_key
            if key in taken or not key.is_valid():
                break
            cap = max(
                min(
                    self.spec.max_batch,
                    self.engine.ready_batch_limit(key),
                ),
                1,
            )
            n = 0
            while (
                idx + n < len(self._queue)
                and n < cap
                and self._queue[idx + n].subgraph_key == key
            ):
                n += 1
            runs.append((key, n))
            taken.add(key)
            idx += n
        if not runs:
            return [first]
        cand = [(first[0].subgraph_key, bucket_of(len(first)))] + [
            (key, bucket_of(n)) for key, n in runs
        ]
        cand.sort(key=lambda kb: subgraph_sort_key(kb[0]))
        if not self.engine.co_dispatch_ready(tuple(cand)):
            return [first]
        groups = [first]
        for _key, n in runs:
            groups.append([self._queue.popleft() for _ in range(n)])
        # canonical signature order (every rotation of the same mix
        # maps to one combined program)
        groups.sort(key=lambda g: subgraph_sort_key(g[0].subgraph_key))
        return groups

    def _requeue_all(self) -> List[Job]:
        with self._cv:
            jobs = list(self._queue)
            self._queue.clear()
        return jobs

    def get_waiting_time(self) -> int:
        """Sum of expected latencies minus progress of the running job
        (reference: worker_device_queue.cc:44-69).

        Batch-aware: jobs sharing one batched dispatch (same key, same
        invoke stamp) are priced ONCE at the bucket cost, and queued
        same-key runs are priced as the batched dispatches _dequeue_many
        will actually coalesce them into — not as per-job batch-1
        latencies (which would overcount) nor one batch-1 latency per
        window (which underestimates ~5x at b8)."""
        if not self.is_available():
            return LARGE_WAITING_TIME
        total = 0
        now = now_us()
        # group in-flight jobs into their dispatch windows
        groups: Dict[tuple, List[Job]] = {}
        for cur in list(self._inflight_jobs):
            groups.setdefault(
                (cur.subgraph_key, cur.invoke_time), []
            ).append(cur)
        for (key, invoke_time), grp in groups.items():
            expected = self.engine.get_expected_latency(key, len(grp))
            if expected < 0:
                return LARGE_WAITING_TIME
            elapsed = now - invoke_time if invoke_time else 0
            total += max(expected - elapsed, 0)
        # simulate the coalescing of the queued jobs into dispatches
        limit = max(self.spec.max_batch, 1)
        run_key, run_n = None, 0
        for job in list(self._queue) + [None]:
            key = job.subgraph_key if job is not None else None
            if key == run_key and run_n < limit:
                run_n += 1
                continue
            if run_key is not None and run_n:
                expected = self.engine.get_expected_latency(run_key, run_n)
                if expected < 0:
                    return LARGE_WAITING_TIME
                total += expected
            run_key, run_n = key, 1
        return total


class GlobalQueueWorker(Worker):
    """Single in-flight *dispatch*; jobs wait in the planner's global
    queue (reference: band/worker_global_queue.cc).

    Beyond the reference's one-job slot: a global-queue scheduler may
    stack up to ``spec.max_batch`` same-subgraph jobs onto an idle
    worker in one round; they execute as ONE stacked-bucket launch
    sequence (backend/executor.py execute_batched), so the single-slot
    semantics the waiting-time estimate assumes
    (worker_global_queue.cc:25-53) still hold — the batch is one
    dispatch, priced at its bucket's cost."""

    def __init__(self, engine: EngineBase, worker_id: int, spec: WorkerSpec):
        super().__init__(engine, worker_id, spec)
        self._batch: List[Job] = []
        self._started = False

    def enqueue_job(self, job: Job) -> bool:
        if not job.subgraph_key.is_valid():
            return False
        limit = max(
            min(
                self.spec.max_batch,
                self.engine.ready_batch_limit(job.subgraph_key),
            ),
            1,
        )
        with self._cv:
            if self._started:
                return False
            if self._batch and (
                job.subgraph_key != self._batch[0].subgraph_key
                or len(self._batch) >= limit
            ):
                return False
            self._batch.append(job)
            self._cv.notify_all()
        return True

    def is_enqueue_ready(self) -> bool:
        return not self._batch and self.is_available()

    def has_job(self) -> bool:
        return bool(self._batch) and not self._started

    def has_jobs_for(self, model_id: int) -> bool:
        with self._cv:
            return any(
                j.model_id == model_id for j in self._inflight_jobs
            ) or any(j.model_id == model_id for j in self._batch)

    def _dequeue(self) -> Optional[Job]:
        jobs = self._dequeue_many()
        return jobs[0] if jobs else None

    def _dequeue_many(self) -> List[Job]:
        self._started = True
        return list(self._batch)

    def _requeue_all(self) -> List[Job]:
        # an accepted-but-not-started batch can still be rescheduled
        # elsewhere; a started batch is in _inflight_jobs (the
        # quarantine fail path covers it)
        with self._cv:
            if self._started or not self._batch:
                return []
            jobs = list(self._batch)
            self._batch = []
        return jobs

    def _max_depth(self) -> int:
        return 1  # single in-flight dispatch by definition

    def _finish(
        self, rec, ready_hint: bool = False, gen: Optional[int] = None
    ) -> None:
        try:
            super()._finish(rec, ready_hint=ready_hint, gen=gen)
        finally:
            with self._cv:
                # a stale thread clearing the slot would wipe a batch
                # the fresh generation has accepted
                if gen is None or self._gen == gen:
                    self._batch = []
                    self._started = False

    def _on_dispatch_consumed(
        self, jobs: List[Job], gen: Optional[int] = None
    ) -> None:
        # error path consumed the dispatch: free the slot (without this
        # the worker would report busy forever — the one-job slot is
        # normally cleared by _finish)
        with self._cv:
            if gen is None or self._gen == gen:
                self._batch = []
                self._started = False

    def _reset_dispatch_state(self) -> None:
        # a wedged thread can leave the one-dispatch slot claimed
        self._batch = []
        self._started = False

    def get_waiting_time(self) -> int:
        """Remaining time of the in-flight dispatch
        (reference: worker_global_queue.cc:125-164), priced at the
        batch's bucket cost (the whole stacked window is one program)."""
        if not self.is_available():
            return LARGE_WAITING_TIME
        cur = self._batch[0] if self._batch else None
        if cur is None:
            return 0
        expected = self.engine.get_expected_latency(
            cur.subgraph_key, len(self._batch)
        )
        if expected < 0:
            return LARGE_WAITING_TIME
        if not cur.invoke_time:
            return expected
        return max(expected - (now_us() - cur.invoke_time), 0)
