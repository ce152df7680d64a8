"""Engine SPI: the internal interface planner, workers and schedulers
program against (reference: band/engine_interface.h:36-148).

Keeping this seam narrow lets scheduler/planner/worker logic be tested
hermetically against a mock engine with no backend — the reference's
central test fixture (band/test/test_util.h:28-89 MockEngineBase)."""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import Job, SubgraphKey, WorkerType


class EngineBase(abc.ABC):
    """Subset of engine behavior the scheduling stack depends on."""

    # --- request plumbing -------------------------------------------------
    @abc.abstractmethod
    def enqueue_batch(self, jobs: Sequence[Job], push_front: bool = False) -> List[int]:
        ...

    @abc.abstractmethod
    def enqueue_finished_job(self, job: Job) -> None:
        ...

    @abc.abstractmethod
    def trigger(self) -> None:
        """Wake the planner loop."""

    @abc.abstractmethod
    def dispatch(self, job: Job) -> bool:
        """Hand a scheduled job to its assigned worker; False if the
        worker rejects it (busy global-queue worker, throttling)."""

    # --- worker queries ---------------------------------------------------
    @abc.abstractmethod
    def num_workers(self) -> int:
        ...

    @abc.abstractmethod
    def get_worker_waiting_time(self) -> Dict[int, int]:
        """Expected µs until each worker would start a newly enqueued job."""

    @abc.abstractmethod
    def get_idle_workers(self) -> List[int]:
        ...

    @abc.abstractmethod
    def is_worker_available(self, worker_id: int) -> bool:
        ...

    def get_worker_batch_limit(self, worker_id: int) -> int:
        """Continuous-batching window of a worker (1 = no batching).
        Global-queue schedulers use it to stack same-subgraph jobs onto
        an idle worker as one batched dispatch (no reference analogue)."""
        return 1

    def ready_batch_limit(self, key: SubgraphKey) -> int:
        """Largest continuous-batching window dispatchable for `key`
        that has run before; workers and stacking
        schedulers cap coalescing at min(worker limit, this) while a
        background bucket warm-up is in flight (Engine docs).  Default:
        unbounded."""
        return 1 << 30

    # --- model / subgraph queries ----------------------------------------
    def has_model(self, model_id: int) -> bool:
        """False once a model has been unregistered (default: all model
        ids the planner sees are live)."""
        return True

    @abc.abstractmethod
    def get_model_worker(self, model_id: int) -> int:
        """Preassigned worker for fixed-worker scheduling."""

    @abc.abstractmethod
    def get_largest_subgraph_key(
        self, model_id: int, worker_id: int
    ) -> SubgraphKey:
        ...

    @abc.abstractmethod
    def get_subgraph_candidates(
        self, model_id: int, resolved_units: frozenset
    ) -> List[SubgraphKey]:
        """Executable subgraphs whose external deps are resolved
        (reference: engine.cc:1107-1151)."""

    @abc.abstractmethod
    def get_subgraph_with_shortest_latency(
        self, job: Job, waiting: Dict[int, int]
    ) -> Tuple[Optional[SubgraphKey], int]:
        """Best (next subgraph, expected end time) for the job
        (reference: engine.cc:1060-1087)."""

    @abc.abstractmethod
    def is_end_of_model(self, key: SubgraphKey, resolved: frozenset) -> bool:
        """True if executing `key` after `resolved` completes the model."""

    # --- cost model -------------------------------------------------------
    @abc.abstractmethod
    def get_expected_latency(self, key: SubgraphKey, batch: int = 1) -> int:
        """Expected µs of one dispatch of `batch` stacked requests on
        this key (batch > 1 prices a continuous-batching window at its
        bucket cost, not `batch` x the single-request cost)."""

    @abc.abstractmethod
    def get_worst_latency(self, model_id: int) -> int:
        """Max over workers of whole-model latency (SLO scale base,
        reference: engine.cc:476-487)."""

    @abc.abstractmethod
    def update_latency(
        self, key: SubgraphKey, latency_us: int, batch: int = 1
    ) -> None:
        ...

    # --- execution (worker-side) ------------------------------------------
    @abc.abstractmethod
    def invoke(self, key: SubgraphKey, inputs: List[np.ndarray]) -> List:
        ...

    def invoke_batched(
        self, key: SubgraphKey, inputs_list: List[List[np.ndarray]]
    ) -> List[List]:
        """Continuous-batching dispatch; default falls back to serial."""
        return [self.invoke(key, ins) for ins in inputs_list]

    def co_dispatch_ready(self, sig: tuple) -> bool:
        """True when a combined executable for the canonical
        ((SubgraphKey, bucket), ...) signature is warm (it has run
        before).  A False return may schedule a
        background build so a recurring mix becomes fusable later.
        Default: fusion unavailable."""
        return False

    def invoke_multi(
        self, sig: tuple, inputs_groups: List[List[List[np.ndarray]]]
    ) -> List[List[List]]:
        """Run several distinct-subgraph windows as ONE device dispatch
        (window fusion); `inputs_groups` aligns with `sig`.  Returns
        per-group, per-request output lists."""
        raise NotImplementedError

    def probe_subgraph(self, key: SubgraphKey) -> bool:
        """Device-recovery probe: does an invoke of `key` succeed now?
        (reference: Worker::WaitUntilDeviceAvailable, worker.cc:101-110)"""
        return True

    def probe_key_for_worker(self, worker_id: int) -> Optional[SubgraphKey]:
        """Any registered subgraph on the worker, for recovery probes
        when the quarantined worker had nothing in flight."""
        return None

    @abc.abstractmethod
    def try_copy_input_tensors(self, job: Job) -> List[np.ndarray]:
        """Assemble the subgraph's inputs from the input ring buffer and
        the job's accumulated activations (reference: engine.cc:1247-1319)."""

    @abc.abstractmethod
    def try_copy_output_tensors(self, job: Job, outputs: List) -> None:
        """Stash boundary activations / final outputs
        (reference: engine.cc:1333-1365)."""
