"""Engine: the public facade and IEngine implementation.

Owns model executors, workers, planner, latency estimator and the
per-model I/O rings; implements the subgraph-selection queries the
schedulers use (reference: band/engine.{h,cc} — Create engine.cc:42,
RegisterModel :51-289, RequestAsync :455-529, Wait :556-567,
Invoke :843-850, shortest-latency DP :966-1052, candidates :1107-1151,
tensor copies :1247-1365).

Execution model: a worker is one CUDA card (or the host CPU) fed by a
host dispatch thread; Invoke launches a subgraph's kernels on the
dispatch thread's current stream without waiting, and the worker's
retire thread waits on a CUDA event recorded after the launches
(``record_completion``).  Inter-subgraph "tensor copies" are tensors
carried on the job record; a hop to another device moves them with
``Tensor.to`` when the next worker assembles its inputs.  Every worker
of one card launches on that card's default stream, so a hop between
them needs no cross-stream wait, and a hop to the host happens after
the producing worker's retire thread waited on its event.

Hops are priced by link class (runtime/link_costs.py) in the
shortest-latency DP, which runs in the native plan core
(runtime/native/plan_core.cc) when it builds, and in the Python DP
here otherwise.

Co-dispatch: a worker with ``co_dispatch > 1`` may serve several
models' windows as one dispatch once their mix has a combined program
(backend/executor.py ``build_combo``: one CUDA graph per mix on a card),
built on the background warmer thread, never on the dispatch path.  The
resource monitor (monitor/resource_monitor.py) feeds
``_on_resource_update``, which throttles workers on thermal, HBM, clock
or duty-cycle pressure.

Mesh workers and one engine over processes: a worker with several
device ids is a mesh (parallel/mesh.py; ids index the global device
pool, parallel/distributed.py), and a ``distributed`` block brings up
torch.distributed before anything else, so that every process builds the
same engine and the SPMD control plane (parallel/spmd.py) replays the
leader's launches of a mesh spanning processes.  A mesh over more devices
than the pool holds is refused, never wrapped onto fewer.

Counterpart: band_tpu/runtime/engine.py.  Refused with ConfigError: a
compilation cache (nothing is compiled by a JIT) and any backend but
"torch" (backend/factory.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import (
    DeviceFlag,
    Job,
    JobStatus,
    RequestOption,
    SubgraphKey,
    WorkerType,
    bucket_of,
    subgraph_sort_key,
)
from ..backend.executor import build_combo, run_combo
from ..config import RuntimeConfig, WorkerSpec, config_hash
from ..errors import ConfigError, DeadlineExceeded, ExecutionError, NotFound
from ..ir.analyzer import ModelAnalyzer, build_model_spec
from ..ir.model import Model
from ..ir.model_spec import ModelSpec
from ..tracing.job_tracer import tracer
from ..tracing.logger import log_error
from . import native as plan_native
from .engine_interface import EngineBase
from .latency_estimator import LatencyEstimator
from .link_costs import (
    DCN,
    H2D,
    HOST,
    ICI,
    LinkCostTable,
    load_table as load_links,
    measure as measure_links,
    save_table as save_links,
)
from .planner import Planner
from .ring_buffer import TensorRingBuffer
from .tensor import StagedInput
from .worker import DeviceQueueWorker, GlobalQueueWorker, Worker
from ..parallel import distributed as dist
from ..parallel.mesh import Mesh, mesh_spans_processes


def _boundary_bytes(graph, spec) -> Dict[int, int]:
    """bytes of activations produced before and consumed at/after each
    unit boundary (the payload of a cross-worker hop at that point)."""
    unit_of_op = {}
    for ui, ops in enumerate(spec.unit_subgraph_ops):
        for oi in ops:
            unit_of_op[oi] = ui
    producer_unit = {}
    for op in graph.ops:
        for t in op.outputs:
            producer_unit[t] = unit_of_op.get(op.index, 0)
    out: Dict[int, int] = {}
    for boundary in range(spec.num_unit_subgraphs):
        total = 0
        seen = set()
        for op in graph.ops:
            if unit_of_op.get(op.index, 0) < boundary:
                continue
            for t in op.inputs:
                if t < 0 or t in seen:
                    continue
                td = graph.tensor(t)
                if td.is_constant:
                    continue
                pu = producer_unit.get(t)
                if pu is not None and pu < boundary:
                    seen.add(t)
                    total += td.nbytes
        out[boundary] = total
    return out


def _pow2_buckets(max_batch: int) -> List[int]:
    """Continuous-batching bucket sizes 2..max_batch (powers of two)."""
    out = []
    b = 2
    while b <= max_batch:
        out.append(b)
        b *= 2
    return out


def _refuse_unported(config: RuntimeConfig) -> None:
    """ConfigError for every part of a config this package cannot honour
    yet, before any thread starts (nothing is silently ignored)."""
    from ..backend.factory import available_backends

    asks = []
    if config.compilation_cache_dir:
        asks.append("compilation_cache_dir (nothing is compiled by a JIT)")
    for i, spec in enumerate(config.worker.workers):
        if (spec.backend or "torch").lower() not in available_backends():
            asks.append(f"worker {i}: backend {spec.backend!r} (registered: "
                        f"{available_backends()})")
    if asks:
        raise ConfigError(
            "not ported to PyTorch yet: " + "; ".join(asks)
        )


def resolve_device(spec: WorkerSpec) -> torch.device:
    """The torch device of a single-device worker.  A GPU worker's id
    indexes this process's cards (``local_device_ids``, else every
    visible card; ids wrap around them, as band_tpu's do over its local
    devices) and raises when CUDA is absent; it never becomes the CPU."""
    if spec.device == DeviceFlag.CPU:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise ConfigError(
            f"{spec.device.value} worker needs CUDA, which is not available"
        )
    local = dist.local_devices("cuda")
    return local[spec.device_ids[0] % len(local)]


def mesh_dims(spec: WorkerSpec) -> Tuple[int, int]:
    """(dp, tp) of a mesh worker from its mesh_shape: 2-D shapes are
    (dp, tp), 1-D shapes pure tp, default pure tp
    (band_tpu/backend/executor.py mesh_dims)."""
    n = len(spec.device_ids)
    if len(spec.mesh_shape) == 2:
        return spec.mesh_shape[0], spec.mesh_shape[1]
    if len(spec.mesh_shape) == 1:
        return max(n // spec.mesh_shape[0], 1), spec.mesh_shape[0]
    return 1, n


def resolve_mesh(spec: WorkerSpec) -> Mesh:
    """The grid of a mesh worker (band_tpu/runtime/engine.py:334-360):
    its device ids index the GLOBAL pool of its kind (every process's
    cards, or CPU devices, in rank order), since spanning processes is a
    mesh's point.  A mesh beyond the pool raises, never wraps onto fewer
    devices, and a GPU mesh needs CUDA."""
    kind = "cpu" if spec.device == DeviceFlag.CPU else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            f"{spec.device.value} mesh worker needs CUDA, which is not "
            "available")
    pool = dist.devices(kind)
    ids = list(spec.device_ids)
    if len(set(ids)) != len(ids):
        raise ConfigError(f"mesh worker lists a device twice: {ids}")
    if max(ids) >= len(pool):
        raise ConfigError(
            f"mesh worker wants devices {ids} but only {len(pool)} "
            f"{'cards' if kind == 'cuda' else 'CPU devices'} present")
    chosen = [pool[i] for i in ids]
    dp, tp = mesh_dims(spec)
    mesh = Mesh([d.device for d in chosen], dp, tp,
                [d.process_index for d in chosen])
    if not any(mesh.local_cells(r) for r in range(dp)):
        raise ConfigError(
            f"mesh worker devices {ids} hold none of process "
            f"{dist.process_index()}'s")
    return mesh


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (no-op for the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class _ModelRecord:
    def __init__(self, model: Model, spec: ModelSpec):
        self.model = model
        self.spec = spec
        self.executors: Dict[int, "object"] = {}  # worker_id -> ModelExecutor
        self.subgraph_keys: List[SubgraphKey] = []
        # begin-unit -> list of keys starting there (reference:
        # unit_subgraphs_to_subgraph_keys_, engine.h:246-247)
        self.keys_by_begin: Dict[int, List[SubgraphKey]] = {}
        self.input_ring: Optional[TensorRingBuffer] = None
        self.output_ring: Optional[TensorRingBuffer] = None
        self.worker_id: int = 0  # fixed-worker assignment
        # boundary_bytes[u] = bytes of activations crossing the boundary
        # just before unit u (for transfer costing)
        self.boundary_bytes: Dict[int, int] = {}
        # flat arrays for the native planner DP (runtime/native)
        self.plan_tables = None


class Engine(EngineBase):
    def __init__(self, config: RuntimeConfig):
        config.validate()
        _refuse_unported(config)
        self.config = config
        if config.distributed.enabled:
            # multi-process bring-up precedes every device query, so that
            # mesh device ids index the global pool (SURVEY §5.8)
            dist.initialize(config.distributed)
        # each mesh worker's grid (None for a single-device worker), and
        # the device of each worker (a mesh's lead device in this
        # process), resolved before any thread starts; a mesh spanning
        # processes creates its process groups here, worker by worker, in
        # the same order on every process
        self._worker_meshes: List[Optional[Mesh]] = [
            resolve_mesh(spec) if spec.is_mesh else None
            for spec in config.worker.workers
        ]
        for mesh in self._worker_meshes:
            if mesh is not None:
                mesh.attach_groups()
        self._worker_devices: List[torch.device] = [
            resolve_device(spec) if mesh is None else mesh.lead()
            for spec, mesh in zip(config.worker.workers, self._worker_meshes)
        ]
        if config.cpu_mask:
            # engine-wide pinning of the creating thread (reference:
            # global `cpu_masks` + engine.cc:657-668)
            from ..device import cpu as cpu_dev

            mask = cpu_dev.resolve_configured_mask(config.cpu_mask)
            if mask is not None:
                cpu_dev.set_thread_affinity(mask)
        self._models: Dict[int, _ModelRecord] = {}
        self._unregistering: set = set()
        self._model_counter = 0
        self._fault_counts: Dict[int, int] = {}
        self._lock = threading.RLock()
        # (torch.profiler session, log dir) while a device trace runs
        self._device_trace = None
        self._trace_seq = 0

        self.latency_estimator = LatencyEstimator(
            smoothing_factor=config.profile.smoothing_factor,
            num_warmups=config.profile.num_warmups,
            num_runs=config.profile.num_runs,
            profile_data_path=config.profile.profile_data_path,
            config_hash=config_hash(config),
            outlier_clip=config.profile.outlier_clip,
        )

        self.workers: List[Worker] = []
        worker_cls = (
            GlobalQueueWorker
            if config.planner.worker_type == WorkerType.GLOBAL_QUEUE
            else DeviceQueueWorker
        )
        for wid, spec in enumerate(config.worker.workers):
            w = worker_cls(self, wid, spec)
            if spec.availability_check_interval_ms <= 0:
                # per-worker value 0 inherits the pool default
                # (reference: band/config.h:53, default 30 s)
                w._avail_check_ms = (
                    config.worker.availability_check_interval_ms
                )
            self.workers.append(w)
            tracer().register_worker(
                wid, f"{spec.device.value}:{spec.device_ids}"
            )
        # transfer-cost model: one table consumed by BOTH the Python DP
        # (get_transfer_cost_us) and the native decision core (passed by
        # pointer into band_plan_dp) — defaults -> config overrides ->
        # live-transport probe (runtime/link_costs.py)
        self.link_costs = LinkCostTable()
        self._links_path = (
            config.profile.profile_data_path + ".links.json"
            if config.profile.profile_data_path
            else ""
        )
        if config.link_costs:
            self.link_costs.update_from_dict(config.link_costs)
        if config.probe_link_costs:
            # persisted probed tables are keyed by topology hash, like
            # the latency profile DB (stale topologies re-probe)
            if not (self._links_path
                    and load_links(self._links_path, self.link_costs)):
                measure_links(self._local_devices(), self.link_costs)
                if self._links_path:
                    save_links(self.link_costs, self._links_path)
        # native planner decision core (C++, built with the host
        # compiler); when it cannot be built the Python DP runs, and the
        # reason is logged and kept in plan_core_error
        self._plan_lib = plan_native.load()
        self.plan_core = "native" if self._plan_lib is not None else "python"
        self.plan_core_error = plan_native.load_error()
        if self._plan_lib is None:
            log_error("native plan core unavailable, the Python DP plans: "
                      "%s", self.plan_core_error)
        self._plan_tls = threading.local()
        self._plan_workers = plan_native.WorkerTables(
            [self._worker_is_host(w) for w in range(len(self.workers))],
            self._worker_devices,
            [dist.process_index() if mesh is None
             else int(mesh.processes.flat[0])
             for mesh in self._worker_meshes],
        )
        for w in self.workers:
            w.start()

        # tracing: enabled when the planner has a log path (the reference
        # dumps the chrome trace at planner destruction, planner.cc:31-33)
        if config.planner.log_path:
            tracer().enable()

        self.resource_monitor = None
        if config.monitor.enable:
            from ..monitor.resource_monitor import ResourceMonitor

            self.resource_monitor = ResourceMonitor(
                interval_ms=config.monitor.monitor_interval_ms,
                log_path=config.monitor.log_path,
                devices=sorted(
                    {d for d in self._worker_devices if d.type == "cuda"},
                    key=str),
            )
            if (config.monitor.thermal_limit_mc > 0
                    or config.monitor.hbm_limit_fraction > 0
                    or config.monitor.min_device_clock_hz > 0
                    or config.monitor.max_duty_cycle_pct > 0):
                self.resource_monitor.add_callback(self._on_resource_update)
            self.resource_monitor.start()

        self.planner = Planner(self, config.planner)

        # background bucket warmer: the first run of each
        # continuous-batching bucket happens off the registration path.
        # Workers cap their coalescing window at the largest warm bucket
        # while a key's warm-up is pending (ready_batch_limit), so
        # serving starts at b1 immediately and the window grows as
        # buckets land.
        self._warmer_cv = threading.Condition()
        self._warmer_tasks: list = []  # heap of (bucket, seq, key)
        self._warmer_seq = 0
        self._warming_keys: Dict[SubgraphKey, int] = {}  # key -> pending
        self._warmer_stop = threading.Event()
        self._warmer_thread: Optional[threading.Thread] = None
        # held by _profile_model for its whole paused-worker window so
        # background warms can't contaminate isolated b1 profiles
        self._profiling_lock = threading.Lock()

        # multi-model window fusion (co-dispatch): combined programs
        # keyed by a canonical ((SubgraphKey, bucket), ...) signature.
        # Workers with spec.co_dispatch > 1 fuse consecutive
        # distinct-subgraph windows into one dispatch once the mix's
        # program has been built in the background (a CUDA graph on a
        # card), never on the dispatch path.
        self._combo_fns: Dict[tuple, object] = {}
        self._combo_state: Dict[tuple, str] = {}  # pending|ready|failed
        self._combo_limit = 16  # each graph keeps a private memory pool
        self._combo_misses: Dict[tuple, int] = {}
        # a signature must MISS this many times before a background
        # build is scheduled: stream-tail partial windows mint one-off
        # signatures, and only recurring mixes are worth a graph;
        # benchmarks pre-build theirs with warm_co_dispatch
        self.co_warm_miss_threshold = 32
        self._co_dispatch_count = 0

        # failure-detection watchdog: quarantine workers wedged inside
        # one dispatch so requesters unblock and traffic reroutes
        self._watchdog_stop = threading.Event()
        self._watchdog_thread = None
        if any(s.stuck_timeout_ms > 0 for s in config.worker.workers):
            self._watchdog_thread = threading.Thread(
                target=self._watchdog, name="band-watchdog", daemon=True
            )
            self._watchdog_thread.start()

    # ------------------------------------------------------------------
    @staticmethod
    def create(config: RuntimeConfig) -> "Engine":
        return Engine(config)

    def _watchdog(self) -> None:
        from ..tracing.logger import log_error

        specs = self.config.worker.workers
        period = min(
            max(s.stuck_timeout_ms for s in specs) / 4000.0, 2.0
        )
        while not self._watchdog_stop.wait(max(period, 0.05)):
            for w, spec in zip(self.workers, specs):
                if spec.stuck_timeout_ms <= 0 or w._quarantined:
                    continue
                if w._compiling > 0:
                    # first launch builds the kernels: not a wedge
                    continue
                busy_ms = w.busy_for() * 1000.0
                if busy_ms > spec.stuck_timeout_ms:
                    log_error(
                        "worker %d stuck in one dispatch for %.0f ms "
                        "(> %d ms); quarantining — its jobs fail, queued "
                        "work reschedules, traffic reroutes",
                        w.worker_id, busy_ms, spec.stuck_timeout_ms,
                    )
                    requeue = w.quarantine()
                    if requeue:
                        self.enqueue_batch(requeue, push_front=True)
                    self.planner.trigger()

    def shutdown(self) -> None:
        self._watchdog_stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5)
        self._warmer_stop.set()
        with self._warmer_cv:
            self._warmer_cv.notify_all()
        if self._warmer_thread is not None:
            self._warmer_thread.join(timeout=10)
        self.planner.stop()
        for w in self.workers:
            w.stop()
        if self.resource_monitor is not None:
            self.resource_monitor.stop()
        if self.config.profile.profile_data_path:
            self.latency_estimator.dump_profile()
        if self.config.planner.log_path:
            tracer().dump(self.config.planner.log_path)

    def _worker_is_host(self, worker_id: int) -> bool:
        return self.config.worker.workers[worker_id].device == DeviceFlag.CPU

    def _local_devices(self) -> List[torch.device]:
        """Every device of this process that a worker uses, a mesh's
        included (the link-cost probe's card-to-card pair)."""
        out = list(self._worker_devices)
        for mesh in self._worker_meshes:
            if mesh is not None:
                out += [mesh.devices[r, c] for r in range(mesh.shape["dp"])
                        for c in mesh.local_cells(r)]
        return out

    def _spans_processes(self, worker_id: int) -> bool:
        mesh = self._worker_meshes[worker_id]
        return mesh is not None and mesh_spans_processes(mesh)

    def _on_resource_update(self, snap) -> None:
        """Resource-aware throttling (band_tpu/runtime/engine.py:365-432):
        host workers on thermal pressure, GPU workers on the HBM
        pressure of their card (``dev<index>_hbm_*``, keyed by the CUDA
        index) and on a low clock or a high duty cycle; latency-aware
        schedulers then see LARGE_WAITING_TIME and route around them."""
        mon = self.config.monitor
        # per-worker throttle decision = OR over the active policies
        # (each policy contributing must not be able to clear another's
        # throttle)
        decisions = {w.worker_id: False for w in self.workers}
        decided = set()
        if mon.thermal_limit_mc > 0:
            temps = [
                v for k, v in snap.items()
                if k.startswith("thermal_zone") and k.endswith("_mC")
            ]
            hot = bool(temps) and max(temps) >= mon.thermal_limit_mc
            for w in self.workers:
                if self._worker_is_host(w.worker_id):
                    decisions[w.worker_id] |= hot
                    decided.add(w.worker_id)
        if mon.hbm_limit_fraction > 0:
            for w, dev in zip(self.workers, self._worker_devices):
                if self._worker_is_host(w.worker_id):
                    continue
                idx = dev.index if dev.index is not None else 0
                used = snap.get(f"dev{idx}_hbm_in_use_bytes")
                limit = snap.get(f"dev{idx}_hbm_limit_bytes", 0)
                if used is not None and limit > 0:
                    decisions[w.worker_id] |= (
                        used / limit >= mon.hbm_limit_fraction
                    )
                    decided.add(w.worker_id)
        # device-clock / duty-cycle policy for accelerator workers: a
        # downclocked or saturated card reports unavailable
        if mon.min_device_clock_hz > 0 or mon.max_duty_cycle_pct > 0:
            clocks = [
                v for k, v in snap.items()
                if (k.startswith("devfreq_") and k.endswith("_hz"))
                or k.endswith("_clock_hz")
            ]
            duty = [
                v for k, v in snap.items()
                if k.endswith("_duty_cycle_pct")
            ]
            slow = (
                mon.min_device_clock_hz > 0
                and bool(clocks)
                and min(clocks) < mon.min_device_clock_hz
            )
            saturated = (
                mon.max_duty_cycle_pct > 0
                and bool(duty)
                and max(duty) >= mon.max_duty_cycle_pct
            )
            for w in self.workers:
                if not self._worker_is_host(w.worker_id):
                    decisions[w.worker_id] |= slow or saturated
                    decided.add(w.worker_id)
        for w in self.workers:
            if w.worker_id in decided:
                w.set_resource_throttled(decisions[w.worker_id])

    # ------------------------------------------------------------------
    # model registration (reference: engine.cc:51-289)
    # ------------------------------------------------------------------
    def register_model(
        self, model: Model, target_worker: int = -1,
        numerics: Optional[str] = None,
    ) -> int:
        """Register a model (reference: engine.cc:51-289): partition it,
        prepare every subgraph with its weights on its worker's device,
        profile bucket 1 and schedule the batch buckets' warm-up.

        ``numerics`` overrides the engine-wide RuntimeConfig.numerics for
        this model ("exact" | "fast"), so exact and fast models can be
        served side by side on one worker."""
        from ..backend.factory import create_executor

        if numerics is None:
            numerics = self.config.numerics
        if numerics not in ("exact", "fast"):
            raise ConfigError("numerics must be 'exact' or 'fast'")

        with self._lock:
            model_id = self._model_counter
            self._model_counter += 1
        model.model_id = model_id
        graph = model.graph

        # host ops run on single-device host workers: a mesh worker
        # absorbing one would stall its whole device group on a numpy op
        # (band_tpu/runtime/engine.py:461-472)
        spec = build_model_spec(
            graph, [self._worker_is_host(w) and self._worker_meshes[w] is None
                    for w in range(len(self.workers))]
        )
        analyzer = ModelAnalyzer(
            graph,
            spec,
            len(self.workers),
            self.config.subgraph,
            self.config.planner.need_fallback_subgraphs,
        )
        defs = analyzer.create_subgraphs()

        rec = _ModelRecord(model, spec)
        for sdef in defs:
            wid = sdef.worker_id
            if wid not in rec.executors:
                mesh = self._worker_meshes[wid]
                rec.executors[wid] = create_executor(
                    self.config.worker.workers[wid].backend,
                    model_id, graph, wid, self._worker_devices[wid],
                    exact=numerics != "fast",
                    host=self._worker_is_host(wid),
                    **({} if mesh is None else {"mesh": mesh}),
                )
            key = rec.executors[wid].prepare_subgraph(
                sorted(sdef.op_indices), sorted(sdef.unit_indices)
            )
            rec.subgraph_keys.append(key)
            rec.keys_by_begin.setdefault(key.begin_unit, []).append(key)

        rec.input_ring = TensorRingBuffer(
            [graph.tensor(t) for t in graph.inputs]
        )
        rec.output_ring = TensorRingBuffer(
            [graph.tensor(t) for t in graph.outputs]
        )
        rec.boundary_bytes = _boundary_bytes(graph, spec)
        rec.plan_tables = plan_native.PlanTables(
            spec.num_unit_subgraphs, rec.subgraph_keys, rec.boundary_bytes
        )
        for i, key in enumerate(rec.plan_tables.keys):
            self.latency_estimator.bind_slot(
                key, rec.plan_tables.expected_us, i
            )
        if target_worker >= 0:
            rec.worker_id = target_worker
        else:
            supporting = sorted({k.worker_id for k in rec.subgraph_keys})
            rec.worker_id = supporting[model_id % len(supporting)]
        with self._lock:
            self._models[model_id] = rec

        self._profile_model(rec)
        return model_id

    def unregister_model(self, model_id: int) -> None:
        """Remove a registered model (reference: engine.cc:291-316):
        new requests fail with NotFound, queued jobs finish as
        ENQUEUE_FAILED via a planner-thread purge, and in-flight
        dispatches drain before the record is dropped."""
        with self._lock:
            if model_id not in self._models:
                raise NotFound(f"unknown model {model_id}")
            self._unregistering.add(model_id)

        def _finalize() -> bool:
            # runs on the planner thread between scheduling passes
            if any(w.has_jobs_for(model_id) for w in self.workers):
                return False
            with self._lock:
                self._models.pop(model_id, None)
            self.latency_estimator.unbind_model(model_id)
            self._drop_combos_for(model_id)
            return True

        try:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if self.planner.purge_model(model_id, _finalize):
                    return
                time.sleep(0.01)
            # drain timed out (a wedged worker); drop the record anyway,
            # matching the reference's non-draining erase
            with self._lock:
                self._models.pop(model_id, None)
            self.latency_estimator.unbind_model(model_id)
            self._drop_combos_for(model_id)
        finally:
            self._unregistering.discard(model_id)

    @staticmethod
    def _zero_inputs(executor, key: SubgraphKey) -> List[np.ndarray]:
        return [
            np.zeros([max(s, 1) for s in shape], dtype)
            for shape, dtype in executor.program(key).input_specs
        ]

    def _profile_model(self, rec: _ModelRecord) -> None:
        """Profile every prepared subgraph in isolation (reference:
        latency_estimator.cc:62-126: pause workers -> warmup+runs ->
        resume).

        Bucket 1 is profiled synchronously; the continuous-batching
        buckets warm in the background by default
        (profile.background_buckets), else synchronously here with the
        top bucket profiled."""
        if not self.config.profile.online:
            return
        from ..device import cpu as cpu_dev

        for w in self.workers:
            w.pause()
        saved_affinity = cpu_dev.get_thread_affinity()
        self._profiling_lock.acquire()
        try:
            for key in rec.subgraph_keys:
                max_batch = self.config.worker.workers[key.worker_id].max_batch
                top_bucket = 1
                while top_bucket * 2 <= max_batch:
                    top_bucket *= 2
                executor = rec.executors[key.worker_id]
                device = self._worker_devices[key.worker_id]
                use_bg = self.config.profile.background_buckets
                # a mesh spanning processes runs collectives, which every
                # process must issue in one order: only its b1 profile
                # runs, here, in lockstep with the other processes
                if self._spans_processes(key.worker_id):
                    use_bg, max_batch = False, 1
                if use_bg and max_batch > 1:
                    buckets = [
                        b for b in _pow2_buckets(max_batch)
                        if not executor.is_warm(key, b)
                    ]
                    if buckets:
                        self._schedule_bucket_warm(key, buckets)
                if (
                    self.latency_estimator.get_profiled(key) > 0
                    and (use_bg or self.latency_estimator.get_profiled(
                        key, top_bucket) > 0)
                ):
                    continue
                # profile under the worker's configured affinity so the
                # measurement matches serving conditions (reference:
                # latency_estimator.cc:71-90)
                wmask = self.config.worker.workers[key.worker_id].cpu_mask
                if wmask:
                    resolved = cpu_dev.resolve_configured_mask(wmask)
                    if resolved is not None:
                        cpu_dev.set_thread_affinity(resolved)
                inputs = self._zero_inputs(executor, key)

                def invoke():
                    executor.execute(key, inputs)
                    synchronize(device)

                if self.latency_estimator.get_profiled(key) <= 0:
                    self.latency_estimator.profile(key, invoke)
                if use_bg:
                    continue
                # synchronous path: run every bucket once and profile the
                # top one, so get_expected(key, batch) has both
                # interpolation endpoints (b1 and b_max)
                for bucket in _pow2_buckets(max_batch):

                    def invoke_bucket(b=bucket):
                        executor.execute_batched(key, [inputs] * b)
                        synchronize(device)

                    if (
                        bucket == top_bucket
                        and self.latency_estimator.get_profiled(
                            key, bucket
                        ) <= 0
                    ):
                        self.latency_estimator.profile(
                            key, invoke_bucket, batch=bucket
                        )
                    else:
                        invoke_bucket()
        finally:
            self._profiling_lock.release()
            if saved_affinity.num_enabled():
                cpu_dev.set_thread_affinity(saved_affinity)
            for w in self.workers:
                w.resume()

    # ------------------------------------------------------------------
    # background bucket warming
    # ------------------------------------------------------------------
    def _schedule_bucket_warm(self, key: SubgraphKey, buckets) -> None:
        import heapq

        with self._warmer_cv:
            self._warming_keys[key] = (
                self._warming_keys.get(key, 0) + len(buckets)
            )
            for b in buckets:
                self._warmer_seq += 1
                # smallest buckets first ACROSS keys: every model's
                # window starts growing immediately
                heapq.heappush(self._warmer_tasks, (b, self._warmer_seq, key))
            if self._warmer_thread is None:
                self._warmer_thread = threading.Thread(
                    target=self._bucket_warmer,
                    name="band-bucket-warmer",
                    daemon=True,
                )
                self._warmer_thread.start()
            self._warmer_cv.notify_all()

    def _bucket_warmer(self) -> None:
        import heapq
        import traceback

        from ..tracing.logger import log_error

        while True:
            with self._warmer_cv:
                while not self._warmer_tasks and not self._warmer_stop.is_set():
                    self._warmer_cv.wait(timeout=0.5)
                if self._warmer_stop.is_set():
                    return
                bucket, _, key = heapq.heappop(self._warmer_tasks)
            try:
                # serialize against paused-worker profiling windows so
                # a warm execution can't contaminate an isolated profile
                with self._profiling_lock:
                    if isinstance(key, tuple) and key and key[0] == "combo":
                        self._warm_one_combo(key[1])
                    else:
                        self._warm_one_bucket(key, bucket)
            except Exception:
                log_error(
                    "bucket warm failed for %s b%d:\n%s",
                    key, bucket, traceback.format_exc(),
                )
            finally:
                with self._warmer_cv:
                    n = self._warming_keys.get(key, 1) - 1
                    if n <= 0:
                        self._warming_keys.pop(key, None)
                    else:
                        self._warming_keys[key] = n
                    self._warmer_cv.notify_all()
                self.trigger()

    def _warm_one_bucket(self, key: SubgraphKey, bucket: int) -> None:
        rec = self._models.get(key.model_id)
        if rec is None:
            return  # unregistered while the warm was queued
        executor = rec.executors.get(key.worker_id)
        if executor is None:
            return
        inputs = self._zero_inputs(executor, key)
        device = self._worker_devices[key.worker_id]

        def invoke():
            executor.execute_batched(key, [inputs] * bucket)
            synchronize(device)

        max_batch = self.config.worker.workers[key.worker_id].max_batch
        top_bucket = 1
        while top_bucket * 2 <= max_batch:
            top_bucket *= 2
        if (
            bucket == top_bucket
            and self.latency_estimator.get_profiled(key, bucket) <= 0
        ):
            # seed the b_max interpolation endpoint; the sample runs
            # under live traffic, and the outlier-clipped EMA refines it
            self.latency_estimator.profile(key, invoke, batch=bucket)
        else:
            invoke()

    # ------------------------------------------------------------------
    # multi-model window fusion (co-dispatch)
    # ------------------------------------------------------------------
    def _combo_entry_eligible(self, key: SubgraphKey) -> bool:
        """A (key, bucket) may join a combined program only on a
        single-device worker (a mesh's gathers and the SPMD control
        plane's announcements stay individual launches, band_tpu/runtime/
        engine.py:784-788), when its program has no host op (band_tpu
        excludes its eager subgraphs) and is capturable (no WHILE or IF)."""
        rec = self._models.get(key.model_id)
        if rec is None or key.model_id in self._unregistering:
            return False
        ex = rec.executors.get(key.worker_id)
        if ex is None or getattr(ex, "mesh", None) is not None:
            return False
        prog = ex.program(key)
        return not prog.has_custom and prog.capturable

    def co_dispatch_capturable(self, sig: tuple) -> bool:
        """Whether every member of a mix may be captured: False when one
        reads a value on the host (a WHILE or IF model), whose windows
        are then served unfused."""
        for key, _ in sig:
            rec = self._models.get(key.model_id)
            ex = rec.executors.get(key.worker_id) if rec else None
            if ex is not None and not ex.program(key).capturable:
                return False
        return True

    def co_dispatch_ready(self, sig: tuple) -> bool:
        st = self._combo_state.get(sig)
        if st == "ready":
            return True
        if st is None:
            n = self._combo_misses.get(sig, 0) + 1
            self._combo_misses[sig] = n
            if n >= max(self.co_warm_miss_threshold, 1):
                self._schedule_combo_warm(sig)
        return False

    def _schedule_combo_warm(self, sig: tuple) -> None:
        import heapq

        if len(self._combo_state) >= self._combo_limit:
            return
        if not all(self._combo_entry_eligible(k) for k, _ in sig):
            return
        sentinel = ("combo", sig)
        with self._warmer_cv:
            if sig in self._combo_state:
                return
            self._combo_state[sig] = "pending"
            self._combo_misses.pop(sig, None)
            self._warming_keys[sentinel] = 1
            self._warmer_seq += 1
            # sort AFTER every individual bucket warm: a combo needs its
            # members warm, and must not delay the window-growth ramp
            heapq.heappush(
                self._warmer_tasks, (1 << 20, self._warmer_seq, sentinel)
            )
            if self._warmer_thread is None:
                self._warmer_thread = threading.Thread(
                    target=self._bucket_warmer,
                    name="band-bucket-warmer",
                    daemon=True,
                )
                self._warmer_thread.start()
            self._warmer_cv.notify_all()

    def _warm_one_combo(self, sig: tuple) -> None:
        """Build the combined program of ``sig`` (on the background warmer
        thread, under _profiling_lock): every member first runs eagerly
        at its bucket, so that the capture builds and loads no kernel,
        then ``build_combo`` captures them.  Never raises: a failed
        build marks the signature failed, and workers keep dispatching
        window by window."""
        import traceback

        from ..tracing.logger import log_error

        try:
            executors = []
            for key, bucket in sig:
                if not self._combo_entry_eligible(key):
                    self._combo_state[sig] = "failed"
                    return
                ex = self._models[key.model_id].executors[key.worker_id]
                ex.execute_batched(key,
                                   [self._zero_inputs(ex, key)] * bucket)
                synchronize(self._worker_devices[key.worker_id])
                executors.append(ex)
            self._combo_fns[sig] = build_combo(sig, executors)
            self._combo_state[sig] = "ready"
        except Exception:
            self._combo_state[sig] = "failed"
            log_error(
                "co-dispatch combo build failed for %s:\n%s",
                sig, traceback.format_exc(),
            )

    def invoke_multi(
        self, sig: tuple, inputs_groups: List[List[List[np.ndarray]]]
    ) -> List[List[List]]:
        """One dispatch serving several distinct-subgraph windows
        (sig-aligned): a replay of the mix's CUDA graph on a card.  Only
        called by workers after co_dispatch_ready(sig).  The caller
        records the completion event after this returns."""
        self._maybe_fault(sig[0][0].worker_id)
        combo = self._combo_fns.get(sig)
        if combo is None:
            raise ExecutionError(f"co-dispatch combo not ready: {sig}")
        result = run_combo(combo, inputs_groups)
        self._co_dispatch_count += 1
        for (key, bucket), ex in zip(sig, combo.executors):
            ex._mark_warm(key, bucket)
        return result

    @property
    def co_dispatch_count(self) -> int:
        """Fused (multi-window) dispatches served so far."""
        return self._co_dispatch_count

    def _drop_combos_for(self, model_id: int) -> None:
        for sig in [
            s
            for s in list(self._combo_state) + list(self._combo_misses)
            if any(k.model_id == model_id for k, _ in s)
        ]:
            self._combo_state.pop(sig, None)
            self._combo_fns.pop(sig, None)
            self._combo_misses.pop(sig, None)

    def warm_co_dispatch(
        self,
        model_ids: Sequence[int],
        batch,
        timeout: float = 600.0,
    ) -> bool:
        """Pre-build the combined program of a model mix (each model's
        largest subgraph on its assigned worker at bucket ``batch``: an
        int for a uniform mix, or one int per model), so a benchmark's
        steady-state rounds fuse from the first measured window.
        Returns True when the combo is ready."""
        batches = (
            [int(b) for b in batch]
            if isinstance(batch, (list, tuple))
            else [int(batch)] * len(model_ids)
        )
        if len(batches) != len(model_ids):
            raise ValueError("warm_co_dispatch: one batch per model")
        entries = []
        for mid, bsz in zip(model_ids, batches):
            wid = self.get_model_worker(mid)
            key = self.get_largest_subgraph_key(mid, wid)
            if not key.is_valid():
                return False
            entries.append((key, bucket_of(bsz)))
        entries.sort(key=lambda kb: subgraph_sort_key(kb[0]))
        sig = tuple(entries)
        if self._combo_state.get(sig) == "ready":
            return True
        # explicit pre-build: bypass the miss-threshold damping
        self._schedule_combo_warm(sig)
        deadline = time.monotonic() + timeout
        with self._warmer_cv:
            while (
                self._combo_state.get(sig) == "pending"
                and time.monotonic() < deadline
            ):
                self._warmer_cv.wait(timeout=0.2)
        return self._combo_state.get(sig) == "ready"

    def ready_batch_limit(self, key: SubgraphKey) -> int:
        """Largest continuous-batching window dispatchable for ``key``
        that has run before.  Unbounded once a key's background warm-up
        has drained (or if none was scheduled); while warming, workers
        cap coalescing at the largest warm bucket."""
        if key not in self._warming_keys:
            return 1 << 30
        rec = self._models.get(key.model_id)
        if rec is None:
            return 1 << 30
        executor = rec.executors.get(key.worker_id)
        if executor is None:
            return 1 << 30
        return executor.max_warm_bucket(key)

    def wait_buckets_ready(self, timeout: float = 600.0) -> bool:
        """Block until every scheduled background bucket warm completes."""
        deadline = time.monotonic() + timeout
        with self._warmer_cv:
            while self._warming_keys and time.monotonic() < deadline:
                self._warmer_cv.wait(timeout=0.2)
            return not self._warming_keys

    # ------------------------------------------------------------------
    # request path (reference: engine.cc:393-614)
    # ------------------------------------------------------------------
    def request_async(
        self,
        model_id: int,
        inputs: Sequence[np.ndarray],
        option: RequestOption = RequestOption(),
    ) -> int:
        return self.request_async_batch([model_id], [inputs], [option])[0]

    def request_async_batch(
        self,
        model_ids: Sequence[int],
        inputs_batch: Sequence[Sequence[np.ndarray]],
        options: Optional[Sequence[RequestOption]] = None,
    ) -> List[int]:
        options = options or [RequestOption()] * len(model_ids)
        # all-or-nothing: validate every model id before allocating any
        # ring slot (the reference's vector-request contract,
        # engine.cc:455-529)
        recs = []
        for model_id in model_ids:
            if model_id in self._unregistering:
                raise NotFound(f"model {model_id} is being unregistered")
            recs.append(self._rec(model_id))
        jobs = []
        for model_id, inputs, option, rec in zip(
            model_ids, inputs_batch, options, recs
        ):
            job = Job(model_id=model_id)
            job.model_fname = rec.model.name
            job.target_worker_id = option.target_worker
            job.require_callback = option.require_callback
            if option.slo_us > 0:
                job.slo_us = option.slo_us
            elif option.slo_scale > 0:
                job.slo_us = int(
                    self.get_worst_latency(model_id) * option.slo_scale
                )
            handle = rec.input_ring.alloc()
            host_inputs = {}
            for tid, arr in zip(rec.model.graph.inputs, inputs):
                if isinstance(arr, (torch.Tensor, StagedInput)):
                    # device-resident input: zero-copy, bypass the ring
                    job.activations[tid] = arr
                else:
                    host_inputs[tid] = np.asarray(arr)
            if host_inputs:
                rec.input_ring.put(handle, host_inputs)
            job.input_handle = handle
            job.output_handle = rec.output_ring.alloc()
            jobs.append(job)
        return self.enqueue_batch(jobs)

    def request_sync(
        self,
        model_id: int,
        inputs: Sequence[np.ndarray],
        option: RequestOption = RequestOption(),
        timeout: float = 60.0,
    ) -> List[np.ndarray]:
        job_id = self.request_async(model_id, inputs, option)
        return self.wait(job_id, timeout=timeout)

    def wait(self, job_id: int, timeout: float = 60.0) -> List[np.ndarray]:
        statuses = self.planner.wait([job_id], timeout=timeout)
        if job_id not in statuses:
            raise TimeoutError(f"job {job_id} did not finish in {timeout}s")
        status = statuses[job_id]
        if status == JobStatus.SLO_VIOLATION:
            raise DeadlineExceeded(f"job {job_id} dropped: SLO unmeetable")
        if status != JobStatus.SUCCESS:
            raise NotFound(f"job {job_id} failed with {status}")
        return self.get_outputs(job_id)

    def wait_all(
        self,
        job_ids: Sequence[int],
        timeout: float = 120.0,
        raise_on_incomplete: bool = False,
    ) -> Dict[int, JobStatus]:
        """Wait for many jobs; returns {job_id: status} for those that
        finished within the timeout (a partial dict on timeout unless
        raise_on_incomplete turns it into a TimeoutError)."""
        statuses = self.planner.wait(job_ids, timeout=timeout)
        if raise_on_incomplete and len(statuses) < len(set(job_ids)):
            missing = [j for j in job_ids if j not in statuses]
            raise TimeoutError(
                f"{len(missing)} of {len(job_ids)} jobs unfinished after "
                f"{timeout}s (first missing: {missing[:8]})"
            )
        return statuses

    def list_models(self) -> Dict[int, "_ModelRecord"]:
        """Consistent snapshot of the registered-model table, taken
        under the engine's own lock."""
        with self._lock:
            return dict(self._models)

    def model_ids(self) -> List[int]:
        with self._lock:
            return list(self._models)

    def get_outputs(self, job_id: int) -> List[np.ndarray]:
        job = self.planner.get_finished_job(job_id)
        if job is None:
            raise NotFound(f"no finished record for job {job_id}")
        rec = self._rec(job.model_id)
        # device->host on the caller thread; also mirror into the output
        # ring so handle-based consumers see the data
        out = {
            tid: to_host(job.final_outputs[tid])
            for tid in rec.model.graph.outputs
        }
        if rec.output_ring.is_valid(job.output_handle):
            rec.output_ring.put(job.output_handle, out)
        return [out[tid] for tid in rec.model.graph.outputs]

    def start_device_trace(self, log_dir: str) -> None:
        """Start a device-level trace (``torch.profiler``: host ops and,
        on a card, its kernels) that ``stop_device_trace`` writes into
        `log_dir` as a Chrome trace, one ``device_trace-<pid>-<n>.json``
        per start/stop pair (open it in Perfetto or chrome://tracing).
        Complements the job trace (tracing/job_tracer.py)."""
        with self._lock:
            if self._device_trace is not None:
                raise ExecutionError("a device trace is already running")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if any(d.type == "cuda" for d in self._worker_devices):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            self._device_trace = (prof, log_dir)
        tracer().instant("device_trace_start", {"log_dir": log_dir})

    def stop_device_trace(self) -> str:
        """Stop the running device trace and write it; returns the
        trace file's path."""
        import os

        with self._lock:
            running = self._device_trace
            if running is None:
                raise ExecutionError("no device trace is running")
            self._device_trace = None
        prof, log_dir = running
        prof.stop()
        tracer().instant("device_trace_stop")
        os.makedirs(log_dir, exist_ok=True)
        self._trace_seq += 1
        path = os.path.join(
            log_dir, f"device_trace-{os.getpid()}-{self._trace_seq}.json"
        )
        prof.export_chrome_trace(path)
        return path

    def register_callback(self, cb) -> int:
        return self.planner.add_callback(cb)

    def unregister_callback(self, handle: int) -> bool:
        return self.planner.remove_callback(handle)

    # ------------------------------------------------------------------
    # EngineBase SPI
    # ------------------------------------------------------------------
    def _rec(self, model_id: int) -> _ModelRecord:
        rec = self._models.get(model_id)
        if rec is None:
            raise NotFound(f"unknown model {model_id}")
        return rec

    def has_model(self, model_id: int) -> bool:
        return model_id in self._models

    def enqueue_batch(self, jobs, push_front: bool = False) -> List[int]:
        return self.planner.enqueue_batch(jobs, push_front)

    def enqueue_finished_job(self, job: Job) -> None:
        self.planner.enqueue_finished_job(job)

    def trigger(self) -> None:
        self.planner.trigger()

    def dispatch(self, job: Job) -> bool:
        worker = self.workers[job.subgraph_key.worker_id]
        return worker.enqueue_job(job)

    def num_workers(self) -> int:
        return len(self.workers)

    def get_worker_waiting_time(self) -> Dict[int, int]:
        return {w.worker_id: w.get_waiting_time() for w in self.workers}

    def get_idle_workers(self) -> List[int]:
        return [
            w.worker_id
            for w in self.workers
            if w.is_enqueue_ready() and not w.has_job() and not w._processing
        ]

    def get_worker_batch_limit(self, worker_id: int) -> int:
        return max(self.config.worker.workers[worker_id].max_batch, 1)

    def is_worker_available(self, worker_id: int) -> bool:
        return self.workers[worker_id].is_available()

    def get_model_worker(self, model_id: int) -> int:
        return self._rec(model_id).worker_id

    def get_largest_subgraph_key(
        self, model_id: int, worker_id: int
    ) -> SubgraphKey:
        rec = self._rec(model_id)
        executor = rec.executors.get(worker_id)
        if executor is None:
            return SubgraphKey()
        key = executor.largest_subgraph_key()
        return key if key is not None else SubgraphKey()

    def get_subgraph_candidates(
        self, model_id: int, resolved_units: frozenset
    ) -> List[SubgraphKey]:
        """Executable next subgraphs: units disjoint from resolved,
        external deps inside resolved (reference: engine.cc:1107-1151)."""
        rec = self._rec(model_id)
        out = []
        for key in rec.subgraph_keys:
            if key.unit_indices & resolved_units:
                continue
            deps = set()
            for u in key.unit_indices:
                deps |= rec.spec.unit_dependencies[u]
            if deps - set(key.unit_indices) <= resolved_units:
                out.append(key)
        return out

    def get_transfer_cost_us(
        self, model_id: int, begin_unit: int, src_worker: int,
        dst_worker: int, batch: int = 1,
    ) -> int:
        """Expected µs to move the boundary activations entering
        `begin_unit` from src to dst worker.

        The reference's transport is an in-process memcpy it never
        costs (engine.cc:1247-1365); here a hop may cross the host <->
        card link or a card <-> card link, so the scheduler seam must
        see the cost.  Model: fixed launch overhead + bytes / link
        bandwidth, by link class, from the engine's LinkCostTable (the
        same table the native DP consumes).  Two workers on one card
        hop for free: cards are compared by index
        (``native.card_key``), never by ``torch.device`` identity.
        `batch` scales the bytes: a batched window's continuation moves
        B x the boundary activations."""
        if src_worker < 0 or src_worker == dst_worker:
            return 0
        rec = self._rec(model_id)
        nbytes = rec.boundary_bytes.get(begin_unit, 0) * max(batch, 1)
        src_host = self._worker_is_host(src_worker)
        dst_host = self._worker_is_host(dst_worker)
        if src_host != dst_host:
            return self.link_costs.cost_us(H2D, nbytes)
        if src_host:
            return self.link_costs.cost_us(HOST, nbytes)
        tables = self._plan_workers
        if tables.dev[src_worker] == tables.dev[dst_worker]:
            return 0
        if tables.proc[src_worker] != tables.proc[dst_worker]:
            return self.link_costs.cost_us(DCN, nbytes)
        return self.link_costs.cost_us(ICI, nbytes)

    def get_subgraph_with_shortest_latency(
        self, job: Job, waiting: Dict[int, int]
    ) -> Tuple[Optional[SubgraphKey], int]:
        """DP over (unit-range end, worker) states (extends the
        reference DP, engine.cc:966-1052, with inter-hop transfer
        costs): memo[j][w] = earliest finish of units <= j with the last
        hop on worker w; returns the *first* hop of the best path plus
        the path's expected end time.

        Runs in the native C++ core (runtime/native/plan_core.cc) —
        schedulers price every window job through this each round,
        making it the planner's decision hot loop — and in the Python
        DP below, its reference, only when the core did not build.

        Hop bytes scale with the job's window batch (a stacked window's
        continuation moves B x the boundary activations)."""
        if self._plan_lib is None:
            return self._py_get_subgraph_with_shortest_latency(job, waiting)
        rec = self._rec(job.model_id)
        batch = max(job.batch_size, 1)
        resolved = job.resolved_unit_subgraphs
        start = (max(resolved) + 1) if resolved else 0
        if start >= rec.spec.num_unit_subgraphs:
            return None, 0
        n_workers = len(self.workers)
        wvec = getattr(self._plan_tls, "wvec", None)
        if wvec is None or len(wvec) != n_workers:
            wvec = np.zeros(n_workers, np.int64)
            self._plan_tls.wvec = wvec
        else:
            wvec[:] = 0
        for wid, t in waiting.items():
            if 0 <= wid < n_workers:
                wvec[wid] = min(t, 1 << 62)
        prev_worker = (
            job.subgraph_key.worker_id if job.subgraph_key.is_valid() else -1
        )
        return plan_native.plan_dp(
            self._plan_lib, rec.plan_tables, self._plan_workers,
            self.link_costs.table, wvec, start, prev_worker, batch,
        )

    def _py_get_subgraph_with_shortest_latency(
        self, job: Job, waiting: Dict[int, int]
    ) -> Tuple[Optional[SubgraphKey], int]:
        rec = self._rec(job.model_id)
        batch = max(job.batch_size, 1)
        num_units = rec.spec.num_unit_subgraphs
        resolved = job.resolved_unit_subgraphs
        start = (max(resolved) + 1) if resolved else 0
        if start >= num_units:
            return None, 0

        prev_worker = (
            job.subgraph_key.worker_id if job.subgraph_key.is_valid() else -1
        )
        # memo state: {(boundary_unit): {worker: (time, first_hop)}}
        memo: List[Dict[int, Tuple[int, Optional[SubgraphKey]]]] = [
            {} for _ in range(num_units + 1)
        ]
        memo[start][prev_worker] = (0, None)
        for begin in range(start, num_units):
            if not memo[begin]:
                continue
            for key in rec.keys_by_begin.get(begin, []):
                expected = max(self.get_expected_latency(key), 0)
                # waiting saturates at LARGE_WAITING_TIME ("never"), the
                # same clamp the native path applies
                w_wait = min(waiting.get(key.worker_id, 0), 1 << 62)
                nxt = key.end_unit + 1
                for src_w, (t, hop) in memo[begin].items():
                    xfer = self.get_transfer_cost_us(
                        job.model_id, begin, src_w, key.worker_id, batch
                    )
                    end_time = max(t + xfer, w_wait) + expected
                    cur = memo[nxt].get(key.worker_id)
                    if cur is None or end_time < cur[0]:
                        memo[nxt][key.worker_id] = (
                            end_time,
                            hop if hop is not None else key,
                        )
        if not memo[num_units]:
            return None, 0
        best_t, best_hop = min(memo[num_units].values(), key=lambda tv: tv[0])
        return best_hop, best_t

    def is_end_of_model(self, key: SubgraphKey, resolved: frozenset) -> bool:
        rec = self._rec(key.model_id)
        return (
            len(resolved | key.unit_indices) == rec.spec.num_unit_subgraphs
        )

    def get_expected_latency(self, key: SubgraphKey, batch: int = 1) -> int:
        return self.latency_estimator.get_expected(key, batch)

    def get_worst_latency(self, model_id: int) -> int:
        rec = self._rec(model_id)
        worst = 0
        for key in rec.subgraph_keys:
            if len(key.unit_indices) == rec.spec.num_unit_subgraphs:
                worst = max(worst, self.get_expected_latency(key))
        if worst == 0:
            worst = self.latency_estimator.get_worst_model_latency(model_id)
        return worst

    def update_latency(
        self, key: SubgraphKey, latency_us: int, batch: int = 1
    ) -> None:
        self.latency_estimator.update(key, latency_us, batch)

    # ------------------------------------------------------------------
    # execution (worker-side)
    # ------------------------------------------------------------------
    def inject_fault(self, worker_id: int, count: int = 1) -> None:
        """Chaos hook: the next ``count`` invokes on worker_id raise
        ExecutionError, driving the device-error recovery loop."""
        with self._lock:
            self._fault_counts[worker_id] = (
                self._fault_counts.get(worker_id, 0) + count
            )

    def _maybe_fault(self, worker_id: int) -> None:
        if not self._fault_counts:
            return
        with self._lock:
            if self._fault_counts.get(worker_id, 0) > 0:
                self._fault_counts[worker_id] -= 1
                raise ExecutionError(
                    f"injected fault on worker {worker_id}"
                )

    def probe_key_for_worker(self, worker_id: int) -> Optional[SubgraphKey]:
        """Any registered subgraph on the worker (recovery probes)."""
        with self._lock:
            recs = list(self._models.values())
        for rec in recs:
            for key in rec.subgraph_keys:
                if key.worker_id == worker_id:
                    return key
        return None

    def probe_subgraph(self, key: SubgraphKey) -> bool:
        """One device-recovery probe: invoke the failed subgraph with
        zero inputs and wait for it (reference:
        Worker::WaitUntilDeviceAvailable, band/worker.cc:101-110)."""
        try:
            rec = self._rec(key.model_id)
            inputs = self._zero_inputs(rec.executors[key.worker_id], key)
            self.invoke(key, inputs)
            synchronize(self._worker_devices[key.worker_id])
            return True
        except Exception:
            return False

    def _invoke_flagged(self, key: SubgraphKey, fn, batch: int):
        """Run an executor invoke, flagging the worker as compiling
        while a (key, bucket) runs for the first time: the first launch
        of a kernel builds it with nvcc, which the stuck-dispatch
        watchdog must not take for a wedge."""
        rec = self._rec(key.model_id)
        ex = rec.executors[key.worker_id]
        worker = self.workers[key.worker_id]
        if ex.is_warm(key, batch):
            return fn(ex)
        worker._compiling += 1
        try:
            return fn(ex)
        finally:
            worker._compiling -= 1
            # restart the wedge clock so the build isn't charged to it
            st = worker._busy_since
            if st is not None:
                worker._busy_since = (st[0], time.monotonic())

    def invoke(self, key: SubgraphKey, inputs: List[np.ndarray]) -> List:
        self._maybe_fault(key.worker_id)
        return self._invoke_flagged(
            key, lambda ex: ex.execute(key, inputs), 1
        )

    def invoke_batched(
        self, key: SubgraphKey, inputs_list: List[List[np.ndarray]]
    ) -> List[List]:
        self._maybe_fault(key.worker_id)
        return self._invoke_flagged(
            key,
            lambda ex: ex.execute_batched(key, inputs_list),
            len(inputs_list),
        )

    def record_completion(self, worker_id: int) -> Optional[torch.cuda.Event]:
        """A CUDA event recorded on the calling thread's current stream of
        the worker's card, right after the launches it must cover; the
        retire thread synchronises on it.  None for a CPU worker, whose
        launches completed before they returned."""
        device = self._worker_devices[worker_id]
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def try_copy_input_tensors(self, job: Job) -> List:
        """Assemble subgraph inputs from the ring slot (graph inputs) and
        the job's accumulated activations (reference: engine.cc:1247-1319)."""
        rec = self._rec(job.model_id)
        key = job.subgraph_key
        executor = rec.executors[key.worker_id]
        device = self._worker_devices[key.worker_id]
        graph_inputs = set(rec.model.graph.inputs)
        ring = None  # resolved lazily: fully device-staged jobs skip it
        inputs = []
        for tid in executor.input_ids(key):
            if tid in job.activations:
                val = job.activations[tid]
                if isinstance(val, StagedInput):
                    val = val.for_device(device)
                if isinstance(val, torch.Tensor) and val.device != device:
                    # staged on another device or a previous hop's output
                    val = val.to(device)
                inputs.append(val)
            elif tid in graph_inputs:
                if ring is None:
                    ring = rec.input_ring.view(job.input_handle)
                inputs.append(ring[tid])
            else:
                raise NotFound(
                    f"input tensor {tid} for {key} neither activation nor "
                    "graph input"
                )
        return inputs

    def try_copy_output_tensors(self, job: Job, outputs: List) -> None:
        """Stash boundary activations; write final model outputs into the
        output ring (reference: engine.cc:1333-1365)."""
        rec = self._rec(job.model_id)
        key = job.subgraph_key
        executor = rec.executors[key.worker_id]
        graph_outputs = set(rec.model.graph.outputs)
        for tid, val in zip(executor.output_ids(key), outputs):
            job.activations[tid] = val
            if tid in graph_outputs:
                # kept on the device; host copies happen on the caller
                # thread (get_outputs)
                job.final_outputs[tid] = val
        for fj in job.following_jobs:
            fj.final_outputs = job.final_outputs

    def get_model_execution_counts(self) -> Dict[int, int]:
        return self.planner.get_model_execution_counts()

    def model_record(self, model_id: int) -> _ModelRecord:
        return self._rec(model_id)
