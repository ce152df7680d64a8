"""JSON-driven multi-model load generator.

A port of band_tpu/tools/benchmark.py (after the reference's
band_benchmark tool, band/tool/benchmark.cc): the same config schema
(models with period_ms/batch_size/slo, runtime config keys, execution
modes ``periodic`` / ``stream`` / ``workload``) and the same report:
average, p50 and p99 latency, FPS, #processed/#canceled and SLO
satisfaction per model, a total, and the runtime's health
(benchmark.cc:417-582).  Inputs are random (seed 0) and staged with
``StagedInput`` on every worker's ``torch.device``; a relative graph
path resolves against the working directory.

Image-fed models (``"image": <file>`` on a model) decode the file once
(PIL, imported only for such a model) and run the host preprocessing
pipeline on every request (``ImageProcessorBuilder().add_auto_convert``
to the model's first input, native C++ kernels), so the measured rate
includes the data plane, as band_tpu's tool does
(band_tpu/tools/benchmark.py:165-179, 211-219).

Multi-process serving: a config with a ``distributed`` block runs the
same benchmark on every process of a torch.distributed cluster
(``run_distributed``); process 0 drives the load and prints the report.

Usage: python -m band_tpu_torch.tools.benchmark <config.json>
"""

from __future__ import annotations

import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..buffer.buffer import Buffer
from ..buffer.processor import ImageProcessorBuilder
from ..common import JobStatus, RequestOption
from ..config import RuntimeConfig, config_from_dict
from ..errors import ConfigError
from ..ir.model import Model
from ..runtime.engine import Engine
from ..runtime.tensor import StagedInput
from ..tracing.logger import log_warning


@dataclass
class ModelLoadConfig:
    """Per-model load spec (reference: band/tool/benchmark_config.h)."""

    path: str
    batch_size: int = 1
    period_ms: int = 0
    slo_us: int = -1
    slo_scale: float = -1.0
    worker_id: int = -1
    # image-fed mode: path to an image file; every request then runs
    # the host preprocessing pipeline (decode happened once; convert and
    # resize per request) so the measured rate includes the data plane
    image: str = ""
    # per-model numerics override ("exact" | "fast" | "" = engine
    # default)
    numerics: str = ""

    @staticmethod
    def from_dict(d: dict) -> "ModelLoadConfig":
        return ModelLoadConfig(
            path=d.get("graph") or d.get("path"),
            batch_size=int(d.get("batch_size", 1)),
            period_ms=int(d.get("period_ms", 0)),
            slo_us=int(d.get("slo_us", -1)),
            slo_scale=float(d.get("slo_scale", -1.0)),
            worker_id=int(d.get("worker_id", -1)),
            image=str(d.get("image", "")),
            numerics=str(d.get("numerics", "")),
        )


@dataclass
class BenchmarkConfig:
    models: List[ModelLoadConfig]
    execution_mode: str = "periodic"  # periodic | stream | workload
    running_time_ms: int = 10_000
    runtime: RuntimeConfig = None
    # trace-driven mode: [{"time_ms": 5, "model": 0, "batch": 1}, ...]
    workload: list = None

    @staticmethod
    def from_json(path: str) -> "BenchmarkConfig":
        with open(path) as f:
            d = json.load(f)
        return BenchmarkConfig.from_dict(d)

    @staticmethod
    def from_dict(d: dict) -> "BenchmarkConfig":
        models = [ModelLoadConfig.from_dict(m) for m in d.get("models", [])]
        if not models:
            raise ConfigError("benchmark config needs at least one model")
        mode = d.get("execution_mode", "periodic")
        if mode not in ("periodic", "stream", "workload"):
            raise ConfigError(f"unknown execution_mode {mode}")
        runtime = config_from_dict(d)
        if not runtime.worker.workers:
            raise ConfigError("benchmark config needs at least one worker")
        workload = d.get("workload")
        if workload is None and d.get("workload_path"):
            with open(d["workload_path"]) as f:
                workload = json.load(f)
        if mode == "workload" and not workload:
            raise ConfigError(
                "workload mode needs a 'workload' list or 'workload_path'"
            )
        return BenchmarkConfig(
            models=models,
            execution_mode=mode,
            running_time_ms=int(d.get("running_time_ms", 10_000)),
            runtime=runtime,
            workload=workload,
        )


@dataclass
class _ModelStats:
    latencies_us: List[int] = field(default_factory=list)
    canceled: int = 0
    slo_dropped: int = 0  # subset of canceled: planner SLO early-drops


class Benchmark:
    def __init__(self, config: BenchmarkConfig):
        self.config = config
        self.engine = Engine.create(config.runtime)
        self.model_ids: List[int] = []
        self.options: List[RequestOption] = []
        self.inputs: List[List] = []
        # per model: None, or (decoded image, preprocessing pipeline)
        self.preprocs: List = []
        self.stats: Dict[int, _ModelStats] = {}
        rng = np.random.default_rng(0)

        for mc in config.models:
            mid = self.engine.register_model(
                Model.from_path(mc.path), target_worker=mc.worker_id,
                numerics=mc.numerics or None,
            )
            self.model_ids.append(mid)
            self.options.append(
                RequestOption(
                    target_worker=mc.worker_id,
                    slo_us=mc.slo_us,
                    slo_scale=mc.slo_scale,
                )
            )
            g = self.engine.model_record(mid).model.graph
            ins = []
            for t in g.inputs:
                td = g.tensor(t)
                shape = [max(s, 1) for s in td.shape]
                if np.issubdtype(td.dtype, np.integer):
                    info = np.iinfo(td.dtype)
                    arr = rng.integers(info.min, info.max + 1, shape).astype(
                        td.dtype
                    )
                else:
                    arr = rng.standard_normal(shape).astype(td.dtype)
                staged = StagedInput(arr)
                for dev in self.engine._worker_devices:
                    staged.stage(dev)
                ins.append(staged)
            self.inputs.append(ins)
            self.stats[mid] = _ModelStats()
            pre = None
            if mc.image:
                from PIL import Image

                td0 = g.tensor(g.inputs[0])
                src = np.asarray(Image.open(mc.image).convert("RGB"))
                proc = (
                    ImageProcessorBuilder()
                    .add_auto_convert([max(s, 1) for s in td0.shape],
                                      td0.dtype)
                    .build()
                )
                pre = (src, proc)
            self.preprocs.append(pre)

        # pre-build the combined programs of workers configured with
        # co_dispatch > 1: recurring mixes then fuse from the first
        # measured round, and no capture lands inside the measured window
        specs = config.runtime.worker.workers
        if any(s.co_dispatch > 1 for s in specs):
            self.engine.wait_buckets_ready(timeout=900)
            by_worker: Dict[int, List[tuple]] = {}
            for idx, mid in enumerate(self.model_ids):
                wid = self.engine.get_model_worker(mid)
                by_worker.setdefault(wid, []).append(
                    (mid, max(config.models[idx].batch_size, 1))
                )
            for wid, entries in by_worker.items():
                if not (0 <= wid < len(specs)):
                    continue
                spec = specs[wid]
                if spec.co_dispatch <= 1 or len(entries) < 2:
                    continue
                entries = entries[: spec.co_dispatch]
                # a window never holds more than max_batch requests, so
                # a larger batch would warm a signature no round makes
                batches = [min(b, max(spec.max_batch, 1))
                           for _, b in entries]
                if not self.engine.warm_co_dispatch(
                    [m for m, _ in entries], batch=batches, timeout=600,
                ):
                    log_warning(
                        "co-dispatch: the combined program of models %s "
                        "at batches %s on worker %d did not build; their "
                        "windows run unfused",
                        [m for m, _ in entries], batches, wid,
                    )

    def _request_inputs(self, idx: int):
        """Per-request inputs: the static staged tensors, or (image-fed
        mode) a fresh run of the preprocessing pipeline."""
        pre = self.preprocs[idx]
        if pre is None:
            return self.inputs[idx]
        src, proc = pre
        return [proc.to_tensor(Buffer.from_numpy(src))]

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        mode = self.config.execution_mode
        if mode == "periodic":
            self._run_periodic()
        elif mode == "stream":
            self._run_stream()
        else:
            self._run_workload()
        return self.report()

    def _record(self, mid: int, job_ids: List[int]):
        statuses = self.engine.wait_all(job_ids, timeout=120)
        for jid in job_ids:
            status = statuses.get(jid)
            job = self.engine.planner.get_finished_job(jid)
            if status == JobStatus.SUCCESS and job is not None:
                self.stats[mid].latencies_us.append(
                    job.end_time - job.enqueue_time
                )
            else:
                self.stats[mid].canceled += 1
                if status == JobStatus.SLO_VIOLATION:
                    self.stats[mid].slo_dropped += 1

    def _run_periodic(self) -> None:
        """Thread per model: blocking request, then sleep out the rest
        of the period (the reference's closed loop, benchmark.cc:417-445:
        RequestSync, then sleep(period - elapsed)); the effective rate is
        min(1/period, 1/latency)."""
        stop = threading.Event()

        def loop(idx: int):
            mid = self.model_ids[idx]
            mc = self.config.models[idx]
            period = max(mc.period_ms, 1) / 1000.0
            while not stop.is_set():
                t0 = time.perf_counter()
                ids = self.engine.request_async_batch(
                    [mid] * mc.batch_size,
                    [self._request_inputs(idx)] * mc.batch_size,
                    [self.options[idx]] * mc.batch_size,
                )
                self._record(mid, ids)
                dt = time.perf_counter() - t0
                if dt < period:
                    stop.wait(period - dt)

        threads = [
            threading.Thread(target=loop, args=(i,), daemon=True)
            for i in range(len(self.model_ids))
        ]
        for t in threads:
            t.start()
        time.sleep(self.config.running_time_ms / 1000.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)

    def _run_stream(self) -> None:
        """Back-to-back batches of all models
        (reference: benchmark.cc:459-493)."""
        deadline = time.perf_counter() + self.config.running_time_ms / 1000.0
        while time.perf_counter() < deadline:
            batch_ids: List[List[int]] = []
            for idx, mid in enumerate(self.model_ids):
                mc = self.config.models[idx]
                ids = self.engine.request_async_batch(
                    [mid] * mc.batch_size,
                    [self._request_inputs(idx)] * mc.batch_size,
                    [self.options[idx]] * mc.batch_size,
                )
                batch_ids.append(ids)
            for mid, ids in zip(self.model_ids, batch_ids):
                self._record(mid, ids)

    def _run_workload(self) -> None:
        """Trace-driven mode: fire each request at its trace timestamp
        (a BAND_NOT_IMPLEMENTED stub in the reference, benchmark.cc:495)."""
        trace = sorted(self.config.workload or [],
                       key=lambda e: e.get("time_ms", 0))
        t0 = time.perf_counter()
        pending: List = []
        for entry in trace:
            at = entry.get("time_ms", 0) / 1000.0
            delay = at - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            idx = int(entry.get("model", 0))
            mid = self.model_ids[idx]
            batch = int(entry.get("batch", 1))
            ids = self.engine.request_async_batch(
                [mid] * batch, [self._request_inputs(idx)] * batch,
                [self.options[idx]] * batch,
            )
            pending.append((mid, ids))
        for mid, ids in pending:
            self._record(mid, ids)

    # ------------------------------------------------------------------
    def report(self) -> Dict:
        """Aggregate metrics (reference: benchmark.cc:508-582)."""
        out = {}
        for idx, mid in enumerate(self.model_ids):
            st = self.stats[mid]
            mc = self.config.models[idx]
            lat = np.asarray(st.latencies_us, np.float64)
            n_ok = len(lat)
            entry = {
                "model": mc.path.rsplit("/", 1)[-1],
                "processed": n_ok,
                "canceled": st.canceled,
            }
            if n_ok:
                entry["avg_latency_ms"] = float(lat.mean() / 1000.0)
                entry["p50_latency_ms"] = float(np.percentile(lat, 50) / 1000)
                entry["p99_latency_ms"] = float(np.percentile(lat, 99) / 1000)
                entry["fps"] = 1000.0 / entry["avg_latency_ms"]
                slo = mc.slo_us
                if slo <= 0 and mc.slo_scale > 0:
                    slo = int(
                        self.engine.get_worst_latency(mid) * mc.slo_scale
                    )
                if slo > 0:
                    entry["slo_us"] = slo
                    # reference semantics: over non-canceled requests
                    # (benchmark.cc:547-562); the stricter rate below
                    # also charges SLO-dropped jobs
                    entry["slo_satisfaction"] = float((lat < slo).mean())
                    met = int((lat < slo).sum())
                    denom = n_ok + st.slo_dropped
                    entry["slo_satisfaction_incl_dropped"] = (
                        met / denom if denom else 1.0
                    )
            out[f"model_{idx}"] = entry
        all_lat = [
            l for st in self.stats.values() for l in st.latencies_us
        ]
        total_ok = len(all_lat)
        total_cancel = sum(st.canceled for st in self.stats.values())
        out["total"] = {
            "processed": total_ok,
            "canceled": total_cancel,
            "avg_latency_ms": (
                float(np.mean(all_lat) / 1000.0) if all_lat else -1
            ),
        }
        # endurance diagnostics: the programs that have run (each
        # (subgraph, bucket) once warm, plus each captured combo graph)
        # and the process RSS, so long runs can assert bounded growth
        n_programs = sum(
            1 for state in self.engine._combo_state.values()
            if state == "ready"
        )
        for mid in self.model_ids:
            for ex in self.engine.model_record(mid).executors.values():
                n_programs += len(ex._warm)
        out["runtime_health"] = {
            "batched_executables": n_programs,
            # fused multi-model dispatches served (co_dispatch > 1
            # workers); 0 on a fused config means rounds raced past the
            # pre-warmed signature
            "co_dispatched_windows": self.engine.co_dispatch_count,
        }
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        out["runtime_health"]["rss_mb"] = round(
                            float(line.split()[1]) / 1024.0, 1
                        )
                        break
        except OSError:
            pass
        return out

    def shutdown(self) -> None:
        self.engine.shutdown()


def run_distributed(cfg: BenchmarkConfig) -> Optional[Dict]:
    """Multi-process serving: run the SAME benchmark config on every
    process of a torch.distributed cluster (the config's ``distributed``
    block carries coordinator and process identity).  Process 0 drives
    the load and reports; the others register the same models
    (registration is collective: online profiling runs the shared
    sharded programs in lockstep) and replay the leader's cross-process
    launches (parallel/spmd.py).  Returns the report on the leader, None
    on followers (band_tpu/tools/benchmark.py:407-443)."""
    from ..parallel import distributed as dist
    from ..parallel.spmd import SpmdChannel
    from ..runtime.link_costs import measure_dcn

    bench = Benchmark(cfg)
    d = cfg.runtime.distributed
    try:
        channel = SpmdChannel(
            bench.engine,
            coordinator_address=d.coordinator_address or dist.from_env(
            ).coordinator_address,
            control_port=d.control_port,
        )
        channel.barrier()
        # probe the cross-process payload path so HEFT/SEL price DCN hops
        # from measurement, not the default (collective: every process
        # runs it here)
        measure_dcn(bench.engine.link_costs)
        if dist.process_index() != 0:
            channel.run_follower()
            return None
        channel.attach()
        try:
            report = bench.run()
            report["link_costs"] = bench.engine.link_costs.to_dict()
        finally:
            channel.shutdown_followers()
        return report
    finally:
        bench.shutdown()


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m band_tpu_torch.tools.benchmark <config.json>",
              file=sys.stderr)
        return 2
    cfg = BenchmarkConfig.from_json(argv[0])
    if cfg.runtime.distributed.enabled:
        report = run_distributed(cfg)
        if report is not None:
            print(json.dumps(report, indent=1))
        return 0
    bench = Benchmark(cfg)
    try:
        report = bench.run()
    finally:
        bench.shutdown()
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
