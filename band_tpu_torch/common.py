"""Core identifiers, enums and job records for the band-tpu runtime.

PyTorch build of the reference's common types (reference:
``band/common.h:32-378``).  A *worker* here is one CUDA card (or the
host CPU) fed by a host dispatch thread, not a mobile processor; a
*subgraph* is a prepared PyTorch program over a contiguous slice of a
model's op graph.
"""

from __future__ import annotations

import enum
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

MICROS = 1_000_000


def now_us() -> int:
    """Monotonic-ish wall clock in microseconds (reference: band/time.cc)."""
    return time.time_ns() // 1_000


def bucket_of(batch: int) -> int:
    """Power-of-two batch bucket of a window of ``batch`` requests.  The
    executor pads to it, the latency table keys on it, and a co-dispatch
    signature names it, so all of them take it from here."""
    return 1 if batch <= 1 else 1 << (batch - 1).bit_length()


class SchedulerType(enum.Enum):
    """Scheduling policies (reference: band/common.h SchedulerType)."""

    FIXED_WORKER = "fixed_worker"
    FIXED_WORKER_GLOBAL_QUEUE = "fixed_worker_global_queue"
    ROUND_ROBIN = "round_robin"
    SHORTEST_EXPECTED_LATENCY = "shortest_expected_latency"
    HETEROGENEOUS_EARLIEST_FINISH_TIME = "heterogeneous_earliest_finish_time"
    LEAST_SLACK_TIME_FIRST = "least_slack_time_first"
    HETEROGENEOUS_EARLIEST_FINISH_TIME_RESERVED = (
        "heterogeneous_earliest_finish_time_reserved"
    )


class DeviceFlag(enum.Enum):
    """Worker device kinds.

    The reference enumerates mobile processors (CPU/GPU/DSP/NPU,
    band/common.h DeviceFlag).  In the PyTorch build a worker is one
    CUDA card or the host CPU; meshed card groups come with the
    multi-GPU work.
    """

    CPU = "cpu"
    GPU = "gpu"


class WorkerType(enum.Enum):
    """Worker queueing discipline (reference: band/common.h WorkerType)."""

    DEVICE_QUEUE = 1
    GLOBAL_QUEUE = 2


class JobStatus(enum.Enum):
    """Lifecycle states of a request (reference: band/common.h JobStatus)."""

    ENQUEUE_FAILED = "enqueue_failed"
    QUEUED = "queued"
    SUCCESS = "success"
    SLO_VIOLATION = "slo_violation"
    INVOKE_FAILURE = "invoke_failure"


class SubgraphPreparationType(enum.Enum):
    """How a registered model is partitioned into executable subgraphs
    (reference: band/common.h SubgraphPreparationType)."""

    NO_FALLBACK_SUBGRAPH = "no_fallback_subgraph"
    FALLBACK_PER_WORKER = "fallback_per_worker"
    UNIT_SUBGRAPH = "unit_subgraph"
    MERGE_UNIT_SUBGRAPH = "merge_unit_subgraph"


class QuantScheme(enum.Enum):
    """Quantization family of a tensor/model."""

    NONE = "none"
    AFFINE_PER_TENSOR = "affine_per_tensor"
    AFFINE_PER_CHANNEL = "affine_per_channel"


@dataclass(frozen=True)
class SubgraphKey:
    """Identifies one compiled executable: (model, worker, unit-subgraph set).

    The reference packs unit indices in a bitset (band/common.h:293-319);
    we use a frozenset of unit indices with the same semantics.  An empty
    ``unit_indices`` marks an invalid key.
    """

    model_id: int = -1
    worker_id: int = -1
    unit_indices: frozenset = frozenset()

    def is_valid(self) -> bool:
        return self.model_id >= 0 and self.worker_id >= 0

    @property
    def begin_unit(self) -> int:
        return min(self.unit_indices) if self.unit_indices else -1

    @property
    def end_unit(self) -> int:
        return max(self.unit_indices) if self.unit_indices else -1

    def bitmask(self) -> int:
        mask = 0
        for i in self.unit_indices:
            mask |= 1 << i
        return mask

    def __str__(self) -> str:
        units = ",".join(str(i) for i in sorted(self.unit_indices))
        return f"(m{self.model_id} w{self.worker_id} [{units}])"


def subgraph_sort_key(key: SubgraphKey) -> tuple:
    """Deterministic total order over SubgraphKeys.  Co-dispatch
    signatures (engine/worker window fusion) canonicalize their group
    order with this so every rotation of the same model mix maps to ONE
    combined executable instead of one per arrival order."""
    return (key.model_id, key.worker_id, tuple(sorted(key.unit_indices)))


@dataclass(frozen=True)
class RequestOption:
    """Per-request knobs (reference: band/common.h:283-290)."""

    target_worker: int = -1
    require_callback: bool = True
    slo_us: int = -1
    slo_scale: float = -1.0

    @staticmethod
    def default() -> "RequestOption":
        return RequestOption()


_job_counter = itertools.count()


@dataclass
class Job:
    """One inference request (or one subgraph hop of a partitioned request).

    Carries full timing provenance for tracing and SLO accounting
    (reference: band/common.h:333-378).  All times in microseconds.
    """

    model_id: int = -1
    job_id: int = -1
    # timing
    enqueue_time: int = 0
    invoke_time: int = 0
    end_time: int = 0
    profiled_execution_time: int = 0
    expected_execution_time: int = 0
    expected_latency: int = 0
    slo_us: int = 0
    # status / routing
    status: JobStatus = JobStatus.QUEUED
    subgraph_key: SubgraphKey = field(default_factory=SubgraphKey)
    target_worker_id: int = -1
    # multi-subgraph chaining (reference: band/common.h:366-372)
    resolved_unit_subgraphs: frozenset = frozenset()
    following_jobs: List["Job"] = field(default_factory=list)
    # I/O staging handles into the per-model tensor ring buffers
    input_handle: int = -1
    output_handle: int = -1
    model_fname: str = ""
    # continuous-batching provenance: how many same-subgraph jobs the
    # scheduler stacked into this job's dispatch window (1 = alone);
    # SLO checks price the job at its bucket cost, not the batch-1 cost
    batch_size: int = 1
    require_callback: bool = True
    # set once the job's outcome is decided (success enqueued, or handed
    # off as a continuation); error-path retirement skips such jobs
    retired: bool = False
    # boundary activations handed between subgraph hops of one request
    # (the TPU-native replacement for cross-interpreter tensor memcpy,
    # reference: engine.cc:1261-1285)
    activations: Dict[int, Any] = field(default_factory=dict)
    # final model outputs as device arrays; materialized to host on the
    # caller thread in Engine.get_outputs (some TPU transports only
    # allow device->host transfers from the main thread)
    final_outputs: Dict[int, Any] = field(default_factory=dict)

    def is_root(self) -> bool:
        """True if this job is the first hop of its request."""
        return not self.resolved_unit_subgraphs

    def remaining_slo_us(self, now: Optional[int] = None) -> int:
        if self.slo_us <= 0:
            return 1 << 62
        now = now_us() if now is None else now
        return self.slo_us - (now - self.enqueue_time)

    def to_json(self) -> Dict[str, Any]:
        """Serialize for trace output (reference: band/common.cc:478)."""
        return {
            "model_id": self.model_id,
            "job_id": self.job_id,
            "enqueue_time": self.enqueue_time,
            "invoke_time": self.invoke_time,
            "end_time": self.end_time,
            "profiled_execution_time": self.profiled_execution_time,
            "expected_execution_time": self.expected_execution_time,
            "expected_latency": self.expected_latency,
            "slo_us": self.slo_us,
            "status": self.status.value,
            "subgraph_key": str(self.subgraph_key),
            "worker_id": self.subgraph_key.worker_id,
            "unit_indices": sorted(self.subgraph_key.unit_indices),
        }


# A scheduling decision: dispatch `job` to `key.worker_id` running `key`.
ScheduleAction = Tuple[Job, SubgraphKey]

# End-of-request callback: (job_id, status)
RequestCallback = Callable[[int, JobStatus], None]


class SafeEvent:
    """Notify/wait/terminate primitive driving the planner loop
    (reference: band/safe_bool.h:105-119)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._signaled = False
        self._terminated = False

    def notify(self) -> None:
        with self._cond:
            self._signaled = True
            self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until notified (or `timeout` seconds).  Returns True
        if terminating."""
        with self._cond:
            if not self._signaled and not self._terminated:
                self._cond.wait(timeout=timeout)
            self._signaled = False
            return self._terminated

    def terminate(self) -> None:
        with self._cond:
            self._terminated = True
            self._cond.notify_all()
