"""The port's benchmark tool (band_tpu_torch/tools/benchmark.py) against
band_tpu's (tests/test_benchmark_tool.py's contracts) on CPU workers:
the same bad configs raise in both, the reference schema keys parse,
short periodic, stream and workload runs serve, the report has
band_tpu's keys on the same fc_int8 config, a stream config with
co_dispatch 2 fuses its rounds, image-fed configs parse as band_tpu's
do (ROADMAP A13, ported; served in tests/test_torch_frontends.py), and
so do distributed configs (A15; served in
tests/test_torch_multiprocess.py)."""

import copy
import os

import pytest

import band_tpu as jb
import band_tpu_torch as tb
from band_tpu.tools import benchmark as jbench
from band_tpu_torch.tools import benchmark as tbench

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FC = os.path.join(DATA, "fc_int8.tflite")
RESNET = os.path.join(DATA, "resnetish_int8.tflite")


def _config(mode="stream", running_ms=300, scheduler="round_robin"):
    return {
        "models": [{"graph": FC, "period_ms": 20, "batch_size": 2,
                    "slo_scale": 100.0}],
        "schedulers": [scheduler],
        "execution_mode": mode,
        "workers": [{"device": "cpu", "device_ids": [0]},
                    {"device": "cpu", "device_ids": [1]}],
        "running_time_ms": running_ms,
        "profile_online": True,
        "profile_warmup_runs": 1,
        "profile_num_runs": 1,
    }


BAD_CONFIGS = {
    "no_models": {"models": []},
    "bogus_mode": {"models": [{"graph": "x.tflite"}],
                   "execution_mode": "bogus", "workers": ["cpu"]},
    "no_workers": {"models": [{"graph": "x.tflite"}], "workers": []},
    "workload_without_trace": dict(_config(), execution_mode="workload"),
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_bad_configs_raise_in_both(name):
    for mod, err in ((jbench, jb.ConfigError), (tbench, tb.ConfigError)):
        with pytest.raises(err):
            mod.BenchmarkConfig.from_dict(copy.deepcopy(BAD_CONFIGS[name]))


def test_reference_schema_keys_accepted(tmp_path):
    d = {
        "models": [{"graph": "m.tflite", "period_ms": 30, "batch_size": 3}],
        "log_path": str(tmp_path / "log.json"),
        "schedulers": ["heterogeneous_earliest_finish_time"],
        "minimum_subgraph_size": 1,
        "subgraph_preparation_type": "merge_unit_subgraph",
        "execution_mode": "stream",
        "cpu_masks": "ALL",
        "num_threads": 1,
        "planner_cpu_masks": "PRIMARY",
        "workers": [
            {"device": "CPU", "num_threads": 2, "cpu_masks": "BIG"},
            {"device": "CPU", "num_threads": 2, "cpu_masks": "LITTLE"},
            {"device": "GPU", "num_threads": 1, "cpu_masks": "ALL"},
            {"device": "DSP", "num_threads": 1, "cpu_masks": "PRIMARY"},
            {"device": "NPU", "num_threads": 1, "cpu_masks": "PRIMARY"},
        ],
        "running_time_ms": 10000,
        "profile_smoothing_factor": 0.1,
        "profile_online": True,
        "profile_warmup_runs": 3,
        "profile_num_runs": 50,
        "allow_work_steal": True,
        "availability_check_interval_ms": 30000,
        "schedule_window_size": 10,
    }
    j = jbench.BenchmarkConfig.from_dict(copy.deepcopy(d))
    t = tbench.BenchmarkConfig.from_dict(copy.deepcopy(d))
    for cfg in (j, t):
        assert cfg.execution_mode == "stream"
        assert len(cfg.runtime.worker.workers) == 5
        assert cfg.runtime.profile.num_warmups == 3
        assert cfg.running_time_ms == 10000
        assert [m.batch_size for m in cfg.models] == [3]
    devs = [w.device for w in t.runtime.worker.workers]
    assert devs.count(tb.DeviceFlag.CPU) == 2
    assert devs.count(tb.DeviceFlag.GPU) == 3


def _run(mod, d, **kw):
    bench = mod.Benchmark(mod.BenchmarkConfig.from_dict(copy.deepcopy(d)),
                          **kw)
    try:
        return bench.run(), bench.engine.co_dispatch_count
    finally:
        bench.shutdown()


@pytest.mark.parametrize("mode", ["stream", "periodic"])
def test_short_run(mode):
    report, _ = _run(tbench, _config(mode))
    assert report["total"]["processed"] > 0
    m0 = report["model_0"]
    assert m0["processed"] > 0 and m0["avg_latency_ms"] > 0
    assert m0["model"] == "fc_int8.tflite"
    assert 0.0 <= m0["slo_satisfaction"] <= 1.0
    assert report["runtime_health"]["batched_executables"] >= 2
    assert report["runtime_health"]["rss_mb"] > 0


def test_workload_mode():
    d = dict(_config("workload"),
             workload=[{"time_ms": t, "model": 0, "batch": 2}
                       for t in range(0, 100, 20)])
    report, _ = _run(tbench, d)
    assert report["total"]["processed"] == 10
    assert report["total"]["canceled"] == 0


def _keys(report):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in report.items()}


def test_report_keys_equal_band_tpu():
    """The same fc_int8 config through both tools: the same report keys
    at every level (a JAX CPU worker and a port CPU worker)."""
    d = _config("stream", running_ms=300)
    jreport, _ = _run(jbench, d, stage_inputs_on_device=False)
    treport, _ = _run(tbench, d)
    assert _keys(treport) == _keys(jreport)
    assert treport["model_0"]["processed"] > 0


def test_stream_co_dispatch_fuses_rounds():
    """configs/benchmark_slo_mix_stream.json's shape: models pinned to
    one worker with co_dispatch 2 pre-build their combined program at
    set-up (the batch clamped to max_batch), and the rounds fuse."""
    d = {
        "models": [{"graph": FC, "batch_size": 4, "worker_id": 0},
                   {"graph": RESNET, "batch_size": 8, "worker_id": 0}],
        "schedulers": ["fixed_worker"],
        "execution_mode": "stream",
        "workers": [{"device": "cpu", "device_ids": [0], "max_batch": 4,
                     "dispatch_depth": 4, "co_dispatch": 2}],
        "running_time_ms": 400,
        "profile_online": True,
        "profile_warmup_runs": 1,
        "profile_num_runs": 1,
    }
    bench = tbench.Benchmark(tbench.BenchmarkConfig.from_dict(d))
    try:
        # the pre-warm built the signature the rounds dispatch: both
        # windows at bucket 4 (resnetish's batch 8 clamped to max_batch)
        assert list(bench.engine._combo_state.values()) == ["ready"]
        sig = next(iter(bench.engine._combo_state))
        assert [b for _, b in sig] == [4, 4]
        report = bench.run()
    finally:
        bench.shutdown()
    assert report["total"]["processed"] > 0
    assert report["total"]["canceled"] == 0
    assert report["runtime_health"]["co_dispatched_windows"] > 0


def test_failed_prewarm_warns(monkeypatch):
    """A combined program that does not build is logged as a warning, and
    the rounds still serve unfused."""
    warned = []
    monkeypatch.setattr(tbench, "log_warning",
                        lambda fmt, *a: warned.append(fmt % a))
    monkeypatch.setattr(tb.Engine, "warm_co_dispatch",
                        lambda self, mids, batch, timeout=600.0: False)
    d = {
        "models": [{"graph": FC, "batch_size": 2, "worker_id": 0},
                   {"graph": RESNET, "batch_size": 2, "worker_id": 0}],
        "schedulers": ["fixed_worker"],
        "execution_mode": "stream",
        "workers": [{"device": "cpu", "device_ids": [0], "max_batch": 2,
                     "co_dispatch": 2}],
        "running_time_ms": 200,
        "profile_warmup_runs": 0,
        "profile_num_runs": 1,
    }
    report, fused = _run(tbench, d)
    assert len(warned) == 1 and "did not build" in warned[0]
    assert report["total"]["processed"] > 0 and fused == 0


@pytest.mark.parametrize("ask,item", [
    ({"models": [{"graph": FC, "image": "cat.jpg"}]}, "A13"),
    ({"distributed": {"coordinator_address": "localhost:1234",
                      "num_processes": 2, "process_id": 0}}, "A15"),
])
def test_image_and_distributed_are_refused(ask, item):
    """Neither is refused any more: an image-fed config (A13, the data
    plane) parses with its image path, and a distributed one (A15) with
    its cluster, as band_tpu's do (served on two processes in
    tests/test_torch_multiprocess.py)."""
    d = dict(_config(), **ask)
    cfg = tbench.BenchmarkConfig.from_dict(d)
    ref = jbench.BenchmarkConfig.from_dict(d)
    if item == "A13":
        assert cfg.models[0].image == "cat.jpg"
        assert cfg.models[0].image == ref.models[0].image
        return
    got, want = cfg.runtime.distributed, ref.runtime.distributed
    assert got.enabled and (got.coordinator_address, got.num_processes,
                            got.process_id) == (
        want.coordinator_address, want.num_processes, want.process_id)
