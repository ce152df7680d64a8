"""The port's resource monitor and the engine's throttle policy.

The eight contracts of tests/test_resource_throttle.py on the port, with
fake metric sources: thermal pressure throttles host workers and lets
them go again, a throttled worker serves after recovery, HBM pressure
leaves host workers alone, fake sources feed snapshots and a broken one
is ignored, the clock and duty-cycle policies throttle GPU workers, and
the policies compose (one clearing never lifts another's throttle).
Then the port's ``_on_resource_update`` against band_tpu's on the same
snapshot sequences (the same availability after every snapshot), the
nvidia-smi parser on canned lines, and the card-memory keys."""

import os
import time

import numpy as np
import pytest
import torch

import band_tpu as jb
import band_tpu_torch as tb
from band_tpu_torch.monitor import resource_monitor as rm
from band_tpu_torch.runtime.worker import LARGE_WAITING_TIME
from tests.test_torch_engine import _goldens

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cfg(pkg, **monitor):
    cfg = (pkg.RuntimeConfigBuilder()
           .add_scheduler(pkg.SchedulerType.ROUND_ROBIN)
           .add_worker(pkg.WorkerSpec(device=pkg.DeviceFlag.CPU,
                                      device_ids=(0,)))
           .add_worker(pkg.WorkerSpec(device=pkg.DeviceFlag.CPU,
                                      device_ids=(1,)))
           .profile_warmups(0).profile_runs(1)
           .build())
    for k, v in monitor.items():
        setattr(cfg.monitor, k, v)
    return cfg


def _gpu_second(eng, monkeypatch):
    """Treat worker 1 as a GPU worker on card 1 for the policy (its
    device id, as band_tpu's jax device id is)."""
    monkeypatch.setattr(eng, "_worker_is_host", lambda wid: wid == 0)
    if isinstance(eng, tb.Engine):
        monkeypatch.setattr(eng, "_worker_devices",
                            [torch.device("cpu"), torch.device("cuda", 1)])


@pytest.fixture
def engine():
    eng = tb.Engine.create(_cfg(tb, thermal_limit_mc=90_000.0))
    yield eng
    eng.shutdown()


def test_thermal_throttle_and_recovery(engine):
    assert engine.get_idle_workers() == [0, 1]
    engine._on_resource_update({"thermal_zone0_mC": 95_000.0})
    assert not engine.is_worker_available(0)
    assert not engine.is_worker_available(1)
    assert engine.workers[0].get_waiting_time() == LARGE_WAITING_TIME
    engine._on_resource_update({"thermal_zone0_mC": 60_000.0})
    assert engine.is_worker_available(0)
    assert engine.is_worker_available(1)


def test_throttled_worker_still_serves_after_recovery(engine):
    xs, want = _goldens("fc_int8")
    mid = engine.register_model(
        tb.Model.from_path(os.path.join(DATA, "fc_int8.tflite")))
    engine._on_resource_update({"thermal_zone1_mC": 99_000.0})
    engine._on_resource_update({"thermal_zone1_mC": 50_000.0})
    np.testing.assert_array_equal(
        engine.request_sync(mid, [xs[0]], timeout=60)[0], want[0])


def test_hbm_throttle_leaves_host_workers_alone():
    eng = tb.Engine.create(_cfg(tb, hbm_limit_fraction=0.9))
    try:
        eng._on_resource_update({"dev0_hbm_in_use_bytes": 99.0,
                                 "dev0_hbm_limit_bytes": 100.0})
        assert eng.is_worker_available(0)
        assert eng.is_worker_available(1)
    finally:
        eng.shutdown()


def test_fake_metrics_source_feeds_snapshots():
    calls = {"n": 0}

    def fake_source():
        calls["n"] += 1
        return {"gpu0_clock_hz": 1_980_000_000.0,
                "gpu0_duty_cycle_pct": 55.0}

    mon = rm.ResourceMonitor(interval_ms=10, metrics_sources=[fake_source])
    mon.start()
    deadline = time.monotonic() + 5.0
    snap = {}
    while time.monotonic() < deadline:
        snap = mon.status()
        if "gpu0_clock_hz" in snap:
            break
        time.sleep(0.01)
    mon.stop()
    assert snap.get("gpu0_clock_hz") == 1_980_000_000.0
    assert snap.get("gpu0_duty_cycle_pct") == 55.0
    assert calls["n"] >= 1
    assert not mon._thread.is_alive()


def test_broken_metrics_source_is_ignored():
    def broken():
        raise RuntimeError("no metrics here")

    mon = rm.ResourceMonitor(interval_ms=10, metrics_sources=[broken])
    assert "ts" in mon._collect()


def test_device_clock_policy_throttles_gpu_workers(monkeypatch):
    eng = tb.Engine.create(_cfg(tb, min_device_clock_hz=900_000_000.0))
    try:
        _gpu_second(eng, monkeypatch)
        eng._on_resource_update({"gpu1_clock_hz": 500_000_000.0})
        assert eng.is_worker_available(0)       # host untouched
        assert not eng.is_worker_available(1)   # card throttled
        eng._on_resource_update({"gpu1_clock_hz": 1_980_000_000.0})
        assert eng.is_worker_available(1)
    finally:
        eng.shutdown()


def test_duty_cycle_policy_throttles_and_recovers(monkeypatch):
    eng = tb.Engine.create(_cfg(tb, max_duty_cycle_pct=95.0))
    try:
        _gpu_second(eng, monkeypatch)
        eng._on_resource_update({"gpu1_duty_cycle_pct": 99.0})
        assert not eng.is_worker_available(1)
        eng._on_resource_update({"gpu1_duty_cycle_pct": 60.0})
        assert eng.is_worker_available(1)
    finally:
        eng.shutdown()


def test_hbm_and_clock_policies_compose(monkeypatch):
    eng = tb.Engine.create(_cfg(tb, hbm_limit_fraction=0.9,
                                min_device_clock_hz=900_000_000.0))
    try:
        _gpu_second(eng, monkeypatch)
        # HBM pressure on card 1 AND a healthy clock: still throttled
        eng._on_resource_update({"dev1_hbm_in_use_bytes": 99.0,
                                 "dev1_hbm_limit_bytes": 100.0,
                                 "gpu1_clock_hz": 1_980_000_000.0})
        assert not eng.is_worker_available(1)
        # pressure on another card does not touch this one
        eng._on_resource_update({"dev0_hbm_in_use_bytes": 99.0,
                                 "dev0_hbm_limit_bytes": 100.0,
                                 "gpu1_clock_hz": 1_980_000_000.0})
        assert eng.is_worker_available(1)
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# the throttle decisions against band_tpu's
# ----------------------------------------------------------------------
HBM = {"dev1_hbm_in_use_bytes": 95.0, "dev1_hbm_limit_bytes": 100.0}
HBM_OK = {"dev1_hbm_in_use_bytes": 10.0, "dev1_hbm_limit_bytes": 100.0}
POLICY_CASES = {
    "thermal": (dict(thermal_limit_mc=90_000.0), [
        {"thermal_zone0_mC": 95_000.0}, {"thermal_zone3_mC": 89_999.0},
        {"thermal_zone0_mC": 90_000.0}, {}, {"loadavg_1m": 3.0}]),
    "hbm": (dict(hbm_limit_fraction=0.9), [
        HBM, HBM_OK, {"dev1_hbm_in_use_bytes": 95.0},
        {"dev1_hbm_in_use_bytes": 90.0, "dev1_hbm_limit_bytes": 100.0},
        {"dev1_hbm_in_use_bytes": 1.0, "dev1_hbm_limit_bytes": 0.0}]),
    "clock": (dict(min_device_clock_hz=900e6), [
        {"gpu1_clock_hz": 345e6}, {"devfreq_x_hz": 1e9},
        {"devfreq_x_hz": 1e8, "gpu0_clock_hz": 2e9}, {}]),
    "duty": (dict(max_duty_cycle_pct=80.0), [
        {"gpu0_duty_cycle_pct": 80.0}, {"gpu0_duty_cycle_pct": 79.0},
        {"tpu0_duty_cycle_pct": 99.0}, {}]),
    "all": (dict(thermal_limit_mc=90_000.0, hbm_limit_fraction=0.9,
                 min_device_clock_hz=900e6, max_duty_cycle_pct=80.0), [
        dict(HBM, gpu1_clock_hz=2e9, thermal_zone0_mC=95_000.0),
        dict(HBM_OK, gpu1_clock_hz=2e9, thermal_zone0_mC=50_000.0),
        dict(HBM_OK, gpu1_clock_hz=1e8), dict(HBM_OK, gpu1_duty_cycle_pct=90),
        dict(HBM_OK, gpu1_clock_hz=2e9, gpu1_duty_cycle_pct=10)]),
}


@pytest.mark.parametrize("host_only", [False, True], ids=["gpu", "host"])
@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_throttle_decisions_match_band_tpu(case, host_only, monkeypatch):
    monitor, snaps = POLICY_CASES[case]
    got = {}
    for pkg in (jb, tb):
        eng = pkg.Engine.create(_cfg(pkg, **monitor))
        try:
            if not host_only:
                _gpu_second(eng, monkeypatch)
            got[pkg.__name__] = [
                (eng._on_resource_update(s),
                 [eng.is_worker_available(w) for w in (0, 1)])[1]
                for s in snaps]
        finally:
            eng.shutdown()
    assert got["band_tpu_torch"] == got["band_tpu"]
    # each sequence throttles a worker at some step, but the card
    # policies never throttle a host worker
    card_only = host_only and case not in ("thermal", "all")
    assert any(not all(step) for step in got["band_tpu"]) != card_only


# ----------------------------------------------------------------------
# the card sources
# ----------------------------------------------------------------------
def test_nvidia_smi_parser():
    text = ("0, 35, 1980, 41, 123.45\n"
            "1, [N/A], 345, 33, [N/A]\n"
            "2, [Not Supported], N/A, 50, 71.2\n"
            "garbage line\n"
            "x, 1, 2, 3, 4\n"
            "3, 1, 2\n")
    assert rm.parse_nvidia_smi(text) == {
        "gpu0_duty_cycle_pct": 35.0, "gpu0_clock_hz": 1_980_000_000.0,
        "gpu0_temp_mC": 41_000.0, "gpu0_power_w": 123.45,
        "gpu1_clock_hz": 345_000_000.0, "gpu1_temp_mC": 33_000.0,
        "gpu2_temp_mC": 50_000.0, "gpu2_power_w": 71.2,
    }
    assert rm.parse_nvidia_smi("") == {}


def test_nvidia_smi_source_without_the_tool(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(rm.subprocess, "run", missing)
    assert rm.nvidia_smi_metrics() == {}


def test_card_memory_keys(monkeypatch):
    """dev<index>_hbm_in_use_bytes is the process's allocations on the
    card, dev<index>_hbm_limit_bytes the card's total memory; a CPU
    device adds nothing."""
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 1000 + i)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (5, 80_000 + i))
    mon = rm.ResourceMonitor(
        interval_ms=10, metrics_sources=[],
        devices=[torch.device("cuda", 0), torch.device("cuda", 2),
                 torch.device("cpu")])
    snap = mon._collect()
    assert {k: v for k, v in snap.items() if k.startswith("dev")} == {
        "dev0_hbm_in_use_bytes": 1000.0, "dev0_hbm_limit_bytes": 80_000.0,
        "dev2_hbm_in_use_bytes": 1002.0, "dev2_hbm_limit_bytes": 80_002.0,
    }


def test_engine_runs_the_monitor_and_logs(tmp_path):
    """monitor.enable starts the poller with the engine and shutdown
    stops it; every snapshot lands in the JSON log."""
    log = tmp_path / "monitor.jsonl"
    b = (tb.RuntimeConfigBuilder()
         .add_scheduler(tb.SchedulerType.FIXED_WORKER)
         .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                   device_ids=(0,)))
         .enable_monitor(interval_ms=20, log_path=str(log)))
    b._cfg.monitor.thermal_limit_mc = 1e12
    eng = tb.Engine.create(b.build())
    try:
        mon = eng.resource_monitor
        assert mon is not None and mon._thread.is_alive()
        assert mon._callbacks == [eng._on_resource_update]
        deadline = time.monotonic() + 5.0
        while not mon.status() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "ts" in mon.status()
    finally:
        eng.shutdown()
    assert not mon._thread.is_alive()
    lines = log.read_text().splitlines()
    assert lines and all('"ts"' in line for line in lines)
