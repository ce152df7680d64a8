"""One run of one cell: set-up, the loop's warm-up, the measured window,
the answers judged against the plain reference, the metrics read.

The system under test is ``band_tpu_torch``'s engine with one worker
(``fixed_worker`` scheduler, the configuration's ``max_batch`` and
numerics).  Requests go in through ``Engine.request_async`` as host
arrays and come back through ``Engine.get_outputs`` as host arrays, so
a request's time takes in the planner, the worker's windows, the
executor, the kernels and both copies.
"""

from __future__ import annotations

import collections
import gc
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import spec, trace as trace_mod, work as work_mod
from .client import Answers, Client, Record

WARM_SECONDS = 2.0  # the loop runs this long before the window opens
TRACE_SECONDS = 3.0  # the traced part of a --trace 1 window
DRAIN_SECONDS = 60.0  # answers are waited for this long past the close
REFERENCE_BLOCK = 4  # pool inputs per reference call
FORBIDDEN = ("jax", "jaxlib", "flax", "band_tpu")


@dataclass
class Clock:
    start: float  # the first request of the warm-up
    t0: float  # the window opens
    t1: float  # the window closes


@dataclass
class RunData:
    """What the metric readers read (``portbench/metrics``)."""

    workload: str
    config: dict
    traffic: dict
    clock: Clock
    seconds: float
    setup_s: float
    records: List[Record]
    window: List[Record]  # due in the window, or in flight when it opened
    answered_in_window: int  # answers on the host inside the window
    t0_us: int  # the window's bounds on the engine's clock
    t1_us: int
    windows: Dict[int, int]  # executor windows by bucket, in the window
    mac_per_request: int
    work: List[work_mod.OpWork]
    trace: Optional[trace_mod.TraceSummary] = None
    trace_windows: Dict[int, int] = field(default_factory=dict)
    trace_requests: int = 0
    collector_busy_s: float = 0.0  # the collectors' busy seconds in the window
    collectors: int = 1  # the client's collector threads
    card_busy_s: Optional[float] = None  # the card's busy seconds, whole window
    card_requests: int = 0  # answers on the host while the card was traced


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not hold, each
    compared whole (``band_tpu_torch`` is not ``band_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_pool(seed: int, shape, count: int) -> np.ndarray:
    """``count`` distinct int8 requests of ``shape``, from the seed."""
    rng = np.random.default_rng([seed, 1])
    return rng.integers(-128, 128, size=(count,) + tuple(shape),
                        dtype=np.int8)


def make_engine(bt, config: dict, device: str):
    flag = bt.DeviceFlag.GPU if device == "cuda" else bt.DeviceFlag.CPU
    return bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=flag, device_ids=(0,),
                                  max_batch=int(config["max_batch"])))
        .numerics(config["numerics"])
        .build())


def reference_outputs(model, pool: np.ndarray, used, device: str,
                      weight_bits: int = 8) -> Dict[int, List[np.ndarray]]:
    """The reference's outputs of the pool inputs ``used``, in blocks."""
    import torch

    from .reference.interp import Reference

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = Reference(model, device=device, weight_bits=weight_bits)
    used = sorted(used)
    out: Dict[int, List[np.ndarray]] = {}
    for i in range(0, len(used), REFERENCE_BLOCK):
        block = used[i:i + REFERENCE_BLOCK]
        outs = ref(np.concatenate([pool[p] for p in block], axis=0))
        for j, p in enumerate(block):
            out[p] = [o[j:j + 1] for o in outs]
    return out


def verdict(judged: Dict[str, int], missing: int):
    """``correct`` and the numbers compared, each with its limit: every
    answer byte-equal to the reference's, none missing."""
    checks = dict(judged, missing_answers=missing)
    return (all(v == 0 for v in checks.values()),
            {k: dict(value=v, limit=0) for k, v in checks.items()})


def _snapshot(executor) -> collections.Counter:
    return collections.Counter(dict(executor.windows))


def _delta(after, before) -> Dict[int, int]:
    return {b: n - before.get(b, 0) for b, n in after.items()
            if n - before.get(b, 0)}


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device: str, process_start: float) -> dict:
    """One run.  Returns the result: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with a trace ``breakdown``, and
    ``checks`` (each number compared with its limit)."""
    import torch

    import band_tpu_torch as bt

    from .reference.tflite import read_model

    c = spec.cell(root, workload)
    config, traffic = c["config"], c["traffic"]
    model_path = os.path.join(root, config["model"])
    ref_model = read_model(model_path)
    work = work_mod.conv_family(ref_model)
    first_op = f"op000_{ref_model.ops[0].name}"
    in_shape = ref_model.tensors[ref_model.inputs[0]].shape
    pool = make_pool(seed, in_shape, int(traffic["pool"]))
    loop = spec.loop(root, traffic["loop"])

    build_s = 0.0
    if device == "cuda":
        # the CUDA kernels and the planner's native core are built where
        # the checkout has none (its first run); timed here, so that the
        # build is recorded apart from the rest of the set-up
        from band_tpu_torch.ops.kernels import build as kernel_build
        from band_tpu_torch.runtime import native as plan_native

        t = time.perf_counter()
        kernel_build.build_all()
        plan_native.load()
        build_s = time.perf_counter() - t
    engine = make_engine(bt, config, device)
    client = None
    try:
        mid = engine.register_model(bt.Model.from_path(model_path))
        if not engine.wait_buckets_ready(timeout=1100):
            raise RuntimeError("the engine's bucket warm-up timed out")
        executor = engine.model_record(mid).executors[0]
        client = Client(engine, mid, pool, bt.JobStatus.SUCCESS)
        trace_dir = os.path.join(spec.bench_dir(root), ".trace")
        # an untraced run on a card traces the card's activity alone over
        # the whole window, for its busy time (card_ms_per_req)
        card = None
        if traced:
            # the profiler's first start takes seconds (CUPTI's set-up):
            # pay it here, before any request, and not in the window
            engine.start_device_trace(trace_dir)
            os.remove(engine.stop_device_trace())
        elif device == "cuda":
            card = trace_mod.card_profile()
            card.start()
            card.stop()
            card = trace_mod.card_profile()
        start = time.perf_counter()
        clock = Clock(start, start + WARM_SECONDS,
                      start + WARM_SECONDS + seconds)
        rng = np.random.default_rng([seed, 2])
        sender = threading.Thread(
            target=loop.run, args=(client, traffic, config, clock, rng),
            name="portbench-loop", daemon=True)
        sender.start()
        _sleep_until(clock.t0)
        t0_us = time.time_ns() // 1000
        setup_s = time.perf_counter() - process_start
        before = _snapshot(executor)
        card_span = (0.0, 0.0)
        if card is not None:
            card.start()
            card_span = (time.perf_counter(), 0.0)
        trace_path = None
        trace_windows: Dict[int, int] = {}
        trace_span = (0.0, 0.0)
        if traced:
            # the window's last seconds: the trace stops once the loop has
            # stopped sending, so writing it out delays no request's send
            _sleep_until(max(clock.t1 - TRACE_SECONDS, clock.t0))
            engine.start_device_trace(trace_dir)
            t_a = time.perf_counter()
            w_a = _snapshot(executor)
        _sleep_until(clock.t1)
        t1_us = time.time_ns() // 1000
        if card is not None:
            card_span = (card_span[0], time.perf_counter())
            card.stop()
        windows = _delta(_snapshot(executor), before)
        sender.join(timeout=DRAIN_SECONDS)
        if traced:
            w_b = _snapshot(executor)
            t_b = time.perf_counter()
            trace_path = engine.stop_device_trace()
            trace_windows = _delta(w_b, w_a)
            trace_span = (t_a, t_b)
        client.drain(clock.t1 + DRAIN_SECONDS)
        peak = (int(torch.cuda.max_memory_allocated(0))
                if device == "cuda" else 0)
        kind = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
    finally:
        if client is not None:
            client.close()
        engine.shutdown()
    records = list(client.records.values())
    del engine, executor
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    window = [r for r in records
              if clock.t0 <= r.due < clock.t1
              or (r.due < clock.t0 and (r.done is None or r.done >= clock.t0))]
    run = RunData(
        workload=workload, config=config, traffic=traffic, clock=clock,
        seconds=seconds, setup_s=setup_s, records=records, window=window,
        answered_in_window=sum(1 for r in records if r.ok
                               and clock.t0 <= r.done < clock.t1),
        t0_us=t0_us, t1_us=t1_us, windows=windows,
        mac_per_request=work_mod.mac_per_request(ref_model), work=work,
        trace_windows=trace_windows,
        trace_requests=sum(1 for r in records if r.ok
                           and trace_span[0] <= r.done < trace_span[1]),
        collector_busy_s=sum(r.busy for r in records if r.done is not None
                             and clock.t0 <= r.done < clock.t1),
        collectors=client.collectors,
        card_requests=sum(1 for r in records if r.ok
                          and card_span[0] <= r.done < card_span[1]))
    if card is not None:
        run.card_busy_s, kinds = trace_mod.card_busy(
            card.profiler.kineto_results.events())
        del card
        print(f"portbench: the card's events in the window: {kinds}, busy "
              f"{run.card_busy_s:.6f} s of {card_span[1] - card_span[0]:.3f}"
              f" s, {run.card_requests} answers", file=sys.stderr)
    dev = dict(platform="gpu" if device == "cuda" else "cpu", kind=kind,
               count=1, memory_peak_bytes=peak)
    if trace_path is not None:
        run.trace = trace_mod.summarize(trace_path, first_op)
        os.remove(trace_path)
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    metrics = {}
    for m in c["per_layer"] if traced else c["end_to_end"]:
        value = spec.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])

    answers: Answers = client.answers
    judged = answers.judge(reference_outputs(ref_model, pool,
                                             answers.first.keys(), device))
    missing = sum(1 for r in window if not r.ok)
    correct, checks = verdict(judged, missing)
    result = dict(correct=correct, attempted=len(window), failed=missing,
                  metrics=metrics, device=dev)
    if run.trace is not None:
        result["breakdown"] = dict(
            device_ops=[list(t) for t in trace_mod.top_device_ops(run.trace)],
            idle_gaps=[list(t) for t in run.trace.idle_gaps])
    result["setup_parts"] = dict(build_s=build_s)
    result["checks"] = checks
    per_second = collections.Counter(
        int(r.done - clock.t0) for r in records
        if r.ok and clock.t0 <= r.done < clock.t1)
    print("portbench: answers in each second of the window: "
          f"{[per_second[i] for i in range(int(seconds))]}", file=sys.stderr)
    print("portbench: executor windows by bucket in the window: "
          f"{dict(sorted(windows.items()))}", file=sys.stderr)
    print(f"portbench: set-up {setup_s:.3f} s, of it the kernel build "
          f"{build_s:.3f} s", file=sys.stderr)
    return result
