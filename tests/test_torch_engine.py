"""The PyTorch port's Engine on a CPU worker under fixed_worker: the
same outputs as band_tpu's Engine for sync and async requests, and the
TFLite goldens for every request, byte for byte (tolerance 0).  Plus
the engine's refusals: a GPU worker without CUDA, and every config part
that is not ported yet."""

import os

import numpy as np
import pytest
import torch

import band_tpu as jb
import band_tpu_torch as tb
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _engine(pkg, max_batch=4, **spec):
    cfg = (pkg.RuntimeConfigBuilder()
           .add_scheduler(pkg.SchedulerType.FIXED_WORKER)
           .add_worker(pkg.WorkerSpec(device=pkg.DeviceFlag.CPU,
                                      device_ids=(0,), max_batch=max_batch,
                                      **spec))
           .profile_warmups(1).profile_runs(1)
           .build())
    return pkg.Engine.create(cfg)


def _goldens(name):
    z = np.load(GOLDENS_PATH)
    g = tb.Model.from_path(os.path.join(DATA, f"{name}.tflite")).graph
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    return golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                         len(want)), want


def _serve(eng, pkg, name, xs):
    mid = eng.register_model(
        pkg.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
    assert eng.wait_buckets_ready(timeout=120)
    sync = [eng.request_sync(mid, [x])[0] for x in xs[:3]]
    ids = [eng.request_async(mid, [xs[i % len(xs)]]) for i in range(12)]
    burst = [eng.wait(j)[0] for j in ids]
    return mid, sync, burst


def test_engine_matches_band_tpu_sync_and_async():
    xs, want = _goldens("fc_int8")
    results = {}
    for pkg in (jb, tb):
        eng = _engine(pkg)
        try:
            results[pkg.__name__] = _serve(eng, pkg, "fc_int8", xs)[1:]
        finally:
            eng.shutdown()
    (jsync, jburst), (tsync, tburst) = results["band_tpu"], \
        results["band_tpu_torch"]
    for a, b in zip(tsync + tburst, jsync + jburst):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for i, a in enumerate(tsync):
        np.testing.assert_array_equal(a, want[i])


@pytest.mark.parametrize("name", ["effnetlite_int8", "resnetish_int8",
                                  "fc_int8"])
def test_engine_serves_the_goldens_in_batch_windows(name):
    xs, want = _goldens(name)
    eng = _engine(tb)
    try:
        mid, sync, burst = _serve(eng, tb, name, xs)
        ex = eng.model_record(mid).executors[0]
        for i, out in enumerate(sync):
            np.testing.assert_array_equal(out, want[i])
        for i, out in enumerate(burst):
            np.testing.assert_array_equal(out, want[i % len(xs)])
        # the buckets ran (warm-up, and windows of the burst)
        assert max(ex.windows) == 4
        assert eng.latency_estimator.get_profiled(
            eng.get_largest_subgraph_key(mid, 0)) > 0
        eng.unregister_model(mid)
        assert not eng.has_model(mid)
    finally:
        eng.shutdown()


def test_device_staged_inputs_are_served():
    xs, want = _goldens("fc_int8")
    eng = _engine(tb)
    try:
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, "fc_int8.tflite")))
        staged = tb.StagedInput(xs[0]).stage("cpu")
        np.testing.assert_array_equal(eng.request_sync(mid, [staged])[0],
                                      want[0])
        np.testing.assert_array_equal(
            eng.request_sync(mid, [torch.from_numpy(xs[1])])[0], want[1])
    finally:
        eng.shutdown()


def test_gpu_worker_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the refusal needs its absence")
    cfg = (tb.RuntimeConfigBuilder()
           .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.GPU,
                                     device_ids=(0,)))
           .build())
    with pytest.raises(tb.ConfigError, match="CUDA"):
        tb.Engine.create(cfg)


def _refused_configs():
    def sched(b, s):
        b._cfg.planner.schedulers = [s]

    return {
        "round_robin": lambda b: sched(b, tb.SchedulerType.ROUND_ROBIN),
        "heft": lambda b: sched(
            b, tb.SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME),
        "global_queue": lambda b: sched(
            b, tb.SchedulerType.FIXED_WORKER_GLOBAL_QUEUE),
        "co_dispatch": lambda b: setattr(
            b._cfg.worker.workers[0], "co_dispatch", 2),
        "mesh": lambda b: setattr(
            b._cfg.worker.workers[0], "device_ids", (0, 1)),
        "monitor": lambda b: b.enable_monitor(),
        "link_costs": lambda b: setattr(
            b._cfg, "link_costs", {"h2d": [10.0, 1000.0]}),
        "probe_link_costs": lambda b: setattr(
            b._cfg, "probe_link_costs", True),
        "distributed": lambda b: setattr(
            b._cfg.distributed, "coordinator_address", "localhost:1234"),
        "compilation_cache": lambda b: setattr(
            b._cfg, "compilation_cache_dir", "cache"),
        "fast_numerics": lambda b: b.numerics("fast"),
        "backend": lambda b: setattr(
            b._cfg.worker.workers[0], "backend", "xla"),
    }


@pytest.mark.parametrize("ask", sorted(_refused_configs()))
def test_unported_config_is_refused(ask):
    b = tb.RuntimeConfigBuilder().add_worker(
        tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,)))
    b.add_scheduler(tb.SchedulerType.FIXED_WORKER)
    _refused_configs()[ask](b)
    with pytest.raises(tb.ConfigError, match="not ported"):
        tb.Engine.create(b._cfg)


def test_fast_numerics_per_model_is_refused():
    eng = _engine(tb)
    try:
        with pytest.raises(tb.ConfigError, match="not ported"):
            eng.register_model(
                tb.Model.from_path(os.path.join(DATA, "fc_int8.tflite")),
                numerics="fast")
    finally:
        eng.shutdown()


def test_injected_device_fault_recovers():
    """A failed launch requeues the job, the worker probes the subgraph
    and comes back, and the request still succeeds."""
    xs, want = _goldens("fc_int8")
    eng = _engine(tb, availability_check_interval_ms=20)
    try:
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, "fc_int8.tflite")))
        eng.inject_fault(0, 1)
        np.testing.assert_array_equal(
            eng.request_sync(mid, [xs[0]], timeout=30)[0], want[0])
    finally:
        eng.shutdown()
