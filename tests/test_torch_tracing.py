"""The port's span and counter system (tracing/), on the CPU.

- ``span()`` with nothing on records nothing and enters no
  ``record_function``; under a profile it enters one; with the job tracer
  on it appends one complete event; inside a capture (``spans_off``) it
  enters nothing, nor does a program's run of graph ops.
- A CPU worker serving one window of 5 requests at ``max_batch`` 8 with
  the job tracer on: complete events on native thread ids, the window's
  ``band.stage`` and graph-op spans inside its ``band.window``, the same
  job ids in ``band.request``, ``band.window`` and ``band.get_outputs``,
  and the counters: 8 rows stacked, 3 of them padding.
- The device trace's ``band.window`` spans, taken to Unix time with the
  trace's ``baseTimeNanoseconds``, lie within 1 ms of their job-trace
  twins, on the same thread.
- The dispatch clock: thread CPU time no more than wall time.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import band_tpu_torch as bt
from band_tpu_torch.backend import program as P
from band_tpu_torch.tracing import counters
from band_tpu_torch.tracing.job_tracer import tracer
from band_tpu_torch.tracing.spans import span, spans_off

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODEL = os.path.join(DATA, "fc_int8.tflite")
GRAPH_OP = re.compile(r"^op\d+_\w+$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted(monkeypatch):
    """The names ``torch.profiler.record_function`` is called with."""
    entered = []
    real = torch.profiler.record_function

    def rf(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", rf)
    return entered


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _engine(log_path="", max_batch=8):
    b = (bt.RuntimeConfigBuilder()
         .add_scheduler(bt.SchedulerType.FIXED_WORKER)
         .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.CPU,
                                   device_ids=(0,), max_batch=max_batch))
         .profile_warmups(1).profile_runs(1))
    if log_path:
        b = b.planner_log_path(log_path)
    eng = bt.Engine.create(b.build())
    mid = eng.register_model(bt.Model.from_path(MODEL))
    assert eng.wait_buckets_ready(timeout=120)
    return eng, mid


def _inputs(eng, mid, n, seed=0):
    g = eng.model_record(mid).model.graph
    shape = tuple(g.tensor(g.inputs[0]).shape)
    return np.random.default_rng(seed).integers(
        -128, 128, (n,) + shape).astype(np.int8)


def _one_window(eng, mid, xs):
    """The requests ``xs`` as one window: held in the paused worker's
    queue until all are there.  Returns their job ids and outputs."""
    w = eng.workers[0]
    w.pause()
    ids = eng.request_async_batch([mid] * len(xs), [[x] for x in xs])
    deadline = time.monotonic() + 30
    while len(w._queue) < len(xs) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(w._queue) == len(xs)
    w.resume()
    assert len(eng.wait_all(ids, timeout=60)) == len(xs)
    return ids, [eng.get_outputs(i) for i in ids]


@pytest.mark.parametrize("on", ["nothing", "profiler", "job tracer",
                                "capture"])
def test_span_records_where_its_gates_say(on, counted):
    t = tracer()
    before = len(t.events())
    prof = _profile() if on in ("profiler", "capture") else None
    if on in ("job tracer", "capture"):
        t.enable()
    try:
        if prof is not None:
            prof.start()
        if on == "capture":
            g = bt.Model.from_path(MODEL).graph
            prog = P.build_program(g, range(len(g.ops)))
            fn = prog.make_fn()
            params = P.params_from_jax(prog.params)
            x = torch.zeros(g.tensor(g.inputs[0]).shape, dtype=torch.int8)
            with spans_off():
                with span("band.window", [7]):
                    fn(params, [x])
        else:
            with span("band.window", [7]):
                pass
        added = t.events()[before:]
    finally:
        if prof is not None:
            prof.stop()
        if on in ("job tracer", "capture"):
            t.disable()
    assert counted == (["band.window"] if on == "profiler" else [])
    if on == "job tracer":
        (ev,) = added
        assert ev["ph"] == "X" and ev["name"] == "band.window"
        assert ev["tid"] == threading.get_native_id()
        assert ev["pid"] == os.getpid()
        assert list(ev["args"]["jobs"]) == [7]
    else:
        assert added == []


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_job_trace_of_one_window(tmp_path):
    log = str(tmp_path / "job.json")
    eng, mid = _engine(log)
    try:
        before = counters.snapshot()
        ids, outs = _one_window(eng, mid, _inputs(eng, mid, 5))
        moved = counters.delta(counters.snapshot(), before)
        graph = eng.model_record(mid).model.graph
    finally:
        eng.shutdown()
    assert len(outs) == 5
    assert moved["rows_stacked"] == 8 and moved["rows_padded"] == 3
    with open(log) as f:
        events = json.load(f)["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    spans = [e for e in events if e["ph"] == "X"]
    assert all(e["pid"] == os.getpid() and e["tid"] in names for e in spans)
    jobs = lambda e: (e.get("args") or {}).get("jobs")  # noqa: E731
    (req,) = [e for e in spans if e["name"] == "band.request"]
    assert jobs(req) == ids and names[req["tid"]] == "MainThread"
    (win,) = [e for e in spans if e["name"] == "band.window"]
    assert jobs(win) == ids and names[win["tid"]] == "band-worker-0"
    assert sorted(j for e in spans if e["name"] == "band.get_outputs"
                  for j in jobs(e)) == ids
    on_worker = [e for e in spans if e["tid"] == win["tid"]]
    stages = [e for e in on_worker if e["name"] == "band.stage"]
    ops = [e for e in on_worker if GRAPH_OP.match(e["name"])]
    assert len(stages) == 2  # the ring views, then pad + stack + copy
    assert [e["name"] for e in ops] == [
        f"op{i:03d}_{op.opname}" for i, op in enumerate(graph.ops)]
    assert all(_inside(e, win) for e in stages + ops)
    subgraphs = [e for e in spans if e["cat"] == "subgraph"]
    assert sorted(e["args"]["job_id"] for e in subgraphs) == ids
    assert {e["tid"] for e in subgraphs} == {win["tid"]}
    retire = [e for e in spans if e["name"].startswith("band.retire")]
    assert {names[e["tid"]] for e in retire} == {"band-retire-0"}


def test_device_trace_windows_meet_their_job_trace_twins(tmp_path):
    log = str(tmp_path / "job.json")
    eng, mid = _engine(log, max_batch=4)
    try:
        eng.start_device_trace(str(tmp_path))
        xs = _inputs(eng, mid, 6, seed=1)
        ids = [eng.request_async(mid, [x]) for x in xs]
        assert len(eng.wait_all(ids, timeout=60)) == len(ids)
        path = eng.stop_device_trace()
    finally:
        eng.shutdown()
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    device = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("name") == "band.window"]
    with open(log) as f:
        jobs = [e for e in json.load(f)["traceEvents"]
                if e["ph"] == "X" and e["name"] == "band.window"]
    assert device and len(device) <= len(jobs)
    for e in device:
        start = e["ts"] + base_us
        twin = min(jobs, key=lambda j: abs(j["ts"] - start))
        assert twin["tid"] == e["tid"]
        assert abs(twin["ts"] - start) < 1000
        assert abs(twin["ts"] + twin["dur"] - start - e["dur"]) < 1000
    kept = counters.last_device_trace()
    assert kept is not None and kept.path == path
    assert set(kept.counters) == set(counters.NAMES)


def test_dispatch_clock_cpu_within_wall():
    eng, mid = _engine(max_batch=4)
    try:
        before = counters.snapshot()
        ids = [eng.request_async(mid, [x]) for x in _inputs(eng, mid, 8)]
        assert len(eng.wait_all(ids, timeout=60)) == len(ids)
        moved = counters.delta(counters.snapshot(), before)
    finally:
        eng.shutdown()
    assert 0 < moved["dispatch_cpu_ns"] <= moved["dispatch_wall_ns"]
