"""The PyTorch port's Engine on a CPU worker under fixed_worker: the
same outputs as band_tpu's Engine for sync and async requests, and the
TFLite goldens for every request, byte for byte (tolerance 0).  Plus
the engine's refusals: a GPU worker without CUDA, every config part
that is not ported yet, and an unknown per-model numerics; and the
config parts served since they were ported."""

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


def _sched(b, s):
    b._cfg.planner.schedulers = [s]


def _refused_configs():
    return {
        "mesh": lambda b: setattr(
            b._cfg.worker.workers[0], "device_ids", (0, 1)),
        "distributed": lambda b: setattr(
            b._cfg.distributed, "coordinator_address", "localhost:1234"),
        "compilation_cache": lambda b: setattr(
            b._cfg, "compilation_cache_dir", "cache"),
        "backend": lambda b: setattr(
            b._cfg.worker.workers[0], "backend", "xla"),
    }


def _served_configs():
    """Config parts the engine once refused and serves now (the
    schedulers and link costs since ROADMAP A8, co_dispatch and the
    monitor since A10 and A12)."""
    return {
        "co_dispatch": lambda b: setattr(
            b._cfg.worker.workers[0], "co_dispatch", 2),
        "monitor": lambda b: b.enable_monitor(interval_ms=50),
        "round_robin": lambda b: _sched(b, tb.SchedulerType.ROUND_ROBIN),
        "heft": lambda b: _sched(
            b, tb.SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME),
        "global_queue": lambda b: _sched(
            b, tb.SchedulerType.FIXED_WORKER_GLOBAL_QUEUE),
        "link_costs": lambda b: setattr(
            b._cfg, "link_costs", {"h2d": [10.0, 1000.0]}),
        "probe_link_costs": lambda b: setattr(
            b._cfg, "probe_link_costs", True),
    }


@pytest.mark.parametrize("ask", sorted(_refused_configs()))
def test_unported_config_is_refused(ask):
    b = tb.RuntimeConfigBuilder().add_worker(
        tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,)))
    b.add_scheduler(tb.SchedulerType.FIXED_WORKER)
    _refused_configs()[ask](b)
    with pytest.raises(tb.ConfigError, match="not ported"):
        tb.Engine.create(b._cfg)


@pytest.mark.parametrize("ask", sorted(_served_configs()))
def test_ported_config_is_served(ask):
    """Each of these was refused before; now the engine accepts it and
    serves fc_int8 byte-equal to the goldens."""
    xs, want = _goldens("fc_int8")
    b = tb.RuntimeConfigBuilder().add_worker(
        tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,),
                      max_batch=4))
    b.add_scheduler(tb.SchedulerType.FIXED_WORKER)
    b.profile_warmups(1).profile_runs(1)
    _served_configs()[ask](b)
    eng = tb.Engine.create(b._cfg)
    try:
        if ask == "link_costs":
            assert eng.link_costs.to_dict()["h2d"] == [10, 1000]
        if ask == "probe_link_costs":
            # a host-only engine measures the host memcpy link
            assert eng.link_costs.table[1, 1] >= 1
        if ask == "global_queue":
            assert all(type(w).__name__ == "GlobalQueueWorker"
                       for w in eng.workers)
        if ask == "co_dispatch":
            assert eng.workers[0].spec.co_dispatch == 2
        if ask == "monitor":
            assert eng.resource_monitor._thread.is_alive()
        mid, sync, burst = _serve(eng, tb, "fc_int8", xs)
        for i, out in enumerate(sync):
            np.testing.assert_array_equal(out, want[i])
        for i, out in enumerate(burst):
            np.testing.assert_array_equal(out, want[i % len(xs)])
    finally:
        eng.shutdown()


# public Engine methods and properties of band_tpu the port does not
# have yet, each with the ROADMAP item that brings it: none
UNPORTED_ENGINE_METHODS = {}


def _public_methods(cls):
    return {n for n in dir(cls)
            if not n.startswith("_")
            and (callable(getattr(cls, n))
                 or isinstance(getattr(cls, n), property))}


def test_engine_public_surface_matches_band_tpu():
    """Every public method of band_tpu's Engine is on the port's, but
    for the listed unported ones; the port adds none band_tpu lacks
    beyond its own CUDA completion hook and the check that a co-dispatch
    mix may be captured (a WHILE or IF model's may not)."""
    ref = _public_methods(jb.Engine)
    port = _public_methods(tb.Engine)
    assert set(UNPORTED_ENGINE_METHODS) <= ref
    assert ref - port == set(UNPORTED_ENGINE_METHODS)
    assert port - ref == {"record_completion", "co_dispatch_capturable"}
    for name in ("list_models", "model_ids", "get_model_execution_counts",
                 "start_device_trace", "stop_device_trace",
                 "co_dispatch_count", "warm_co_dispatch", "invoke_multi",
                 "co_dispatch_ready"):
        assert name in port


def test_engine_surface_methods(tmp_path):
    xs, want = _goldens("fc_int8")
    eng = _engine(tb)
    try:
        assert eng.list_models() == {} and eng.model_ids() == []
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, "fc_int8.tflite")))
        assert eng.model_ids() == [mid]
        assert eng.list_models()[mid] is eng.model_record(mid)
        eng.start_device_trace(str(tmp_path))
        with pytest.raises(tb.ExecutionError, match="already running"):
            eng.start_device_trace(str(tmp_path))
        for i in range(2):
            np.testing.assert_array_equal(
                eng.request_sync(mid, [xs[i]])[0], want[i])
        path = eng.stop_device_trace()
        assert os.path.dirname(path) == str(tmp_path)
        with open(path) as f:
            assert "traceEvents" in f.read()
        with pytest.raises(tb.ExecutionError, match="no device trace"):
            eng.stop_device_trace()
        assert eng.get_model_execution_counts() == {mid: 2}
    finally:
        eng.shutdown()


def test_fast_numerics_per_model_is_refused():
    """Per-model numerics other than "exact" and "fast" are refused;
    "fast" itself is served (tests/test_torch_fast.py holds its
    outputs)."""
    eng = _engine(tb)
    try:
        path = os.path.join(DATA, "fc_int8.tflite")
        with pytest.raises(tb.ConfigError, match="'exact' or 'fast'"):
            eng.register_model(tb.Model.from_path(path), numerics="sloppy")
        mid = eng.register_model(tb.Model.from_path(path), numerics="fast")
        assert not eng.model_record(mid).executors[0].exact
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
