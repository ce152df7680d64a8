"""The graph-op spans of the port's programs and tools/xprof_summary.py,
on the CPU.

- A synthetic Chrome trace (two host threads, graph-op spans nested as a
  WHILE's body in the WHILE, kernels tied to their launches by
  correlation id, a CUDA graph replay, a memcpy launched outside any op)
  summed by hand: every key band_tpu's summary returns, each kernel under
  its innermost span, the replay's kernels under the replay.
- A real torch.profiler trace of fsrcnn_x2_small_int8 served through the
  engine on a CPU worker (Engine.start_device_trace / stop_device_trace):
  the worker thread's spans name every op of the model, in order, each
  once; the command line prints band_tpu's three sections.
- With no profile running a program enters no record_function; under a
  profile, one per op; inside a CUDA graph's capture (spans_off), none.
"""

import json
import os

import numpy as np
import pytest
import torch

import band_tpu_torch as bt
from band_tpu_torch.backend import program as P
from band_tpu_torch.tools import xprof_summary as X

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODEL = os.path.join(DATA, "fsrcnn_x2_small_int8.tflite")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU ops: the test workers
    share the cores, and torch's thread pool on busy cores is far slower
    than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def _synthetic(path):
    ev = [
        _x("op000_CONV_2D", "user_annotation", 0, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 5, correlation=1),
        _x("op001_WHILE", "user_annotation", 100, 200),
        _x("op000_ADD", "user_annotation", 120, 50),   # the body, nested
        _x("cudaLaunchKernel", "cuda_runtime", 130, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 250, 5, correlation=3),
        _x("op002_PRELU", "user_annotation", 0, 30, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 5, tid=2, correlation=4),
        _x("cudaGraphLaunch", "cuda_runtime", 400, 5, correlation=5),
        # device events
        _x("conv_kernel", "kernel", 20, 1000, tid=0, correlation=1,
           grid=[4, 1, 1], block=[128, 1, 1]),
        _x("add_kernel", "kernel", 140, 250, tid=0, correlation=2),
        _x("loop_kernel", "kernel", 260, 500, tid=0, correlation=3),
        _x("prelu_kernel", "kernel", 30, 2000, tid=0, correlation=4),
        _x("conv_kernel", "kernel", 410, 3000, tid=0, correlation=5),
        _x("add_kernel", "kernel", 420, 750, tid=0, correlation=5),
        _x("Memcpy HtoD", "gpu_memcpy", 500, 125, tid=0, correlation=99),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_synthetic_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    _synthetic(path)
    s = X.summarize(path, 20)
    assert set(s) == {"total_ms", "modules", "ops", "by_source",
                      "by_graph_op"}
    assert s["total_ms"] == pytest.approx(7.625)
    assert s["modules"] == pytest.approx(
        {"graph ops": 3.75, X.REPLAY: 3.75, X.OUTSIDE: 0.125})
    by_op = {op: (ms, host) for ms, op, host in s["by_graph_op"]}
    assert by_op["op000_CONV_2D"] == pytest.approx((1.0, 0.1))
    assert by_op["op000_ADD"] == pytest.approx((0.25, 0.05))  # innermost
    assert by_op["op001_WHILE"] == pytest.approx((0.5, 0.2))
    assert by_op["op002_PRELU"] == pytest.approx((2.0, 0.03))  # thread 2
    assert by_op[X.REPLAY][0] == pytest.approx(3.75)
    assert dict((t, ms) for ms, t in s["by_source"])["CONV_2D"] == \
        pytest.approx(1.0)
    ops = {nm: (ms, cat, src, shape) for ms, nm, cat, src, shape in s["ops"]}
    assert ops["conv_kernel"][0] == pytest.approx(4.0)
    assert ops["conv_kernel"][3] == "grid [4, 1, 1] block [128, 1, 1]"
    assert ops["Memcpy HtoD"][1:3] == ("gpu_memcpy", X.OUTSIDE)
    # a directory: its newest trace
    assert X.summarize(str(tmp_path))["total_ms"] == s["total_ms"]


def test_engine_trace_names_every_graph_op(tmp_path, capsys):
    eng = bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.CPU, device_ids=(0,),
                                  max_batch=1))
        .build())
    try:
        mid = eng.register_model(bt.Model.from_path(MODEL))
        g = eng.model_record(mid).model.graph
        x = np.random.default_rng(0).integers(
            -128, 128, g.tensor(g.inputs[0]).shape).astype(np.int8)
        want = eng.request_sync(mid, [x])[0]
        eng.start_device_trace(str(tmp_path))
        got = eng.request_sync(mid, [x])[0]
        path = eng.stop_device_trace()
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(got, want)
    s = X.summarize(path, 100)
    names = [op for _, op, _ in s["by_graph_op"]]
    assert sorted(names) == [f"op{i:03d}_{op.opname}"
                             for i, op in enumerate(g.ops)]
    assert all(host > 0 for _, _, host in s["by_graph_op"])
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and X.GRAPH_OP.match(e["name"])]
    assert [e["name"] for e in sorted(spans, key=lambda e: e["ts"])] == \
        [f"op{i:03d}_{op.opname}" for i, op in enumerate(g.ops)]
    assert X.main([path, "5"]) == 0
    out = capsys.readouterr().out
    for head in ("== top ops", "== by op type", "== by graph op"):
        assert head in out


def test_spans_only_while_a_profile_runs(monkeypatch):
    g = bt.Model.from_path(MODEL).graph
    prog = P.build_program(g, range(len(g.ops)))
    params = P.params_from_jax(prog.params)
    fn = prog.make_fn()
    x = torch.zeros(g.tensor(g.inputs[0]).shape, dtype=torch.int8)
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    fn(params, [x])
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn(params, [x])
        spans = [n for n in entered if X.GRAPH_OP.match(n)]
        assert spans == [f"op{i:03d}_{op.opname}"
                         for i, op in enumerate(g.ops)]
        entered.clear()
        with P.spans_off():
            fn(params, [x])
        assert entered == []
    fn(params, [x])
    assert entered == []


def test_host_spans_by_thread(tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    ev = [
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 1,
         "args": {"name": "band-worker-0"}},
        _x("band.window", "user_annotation", 0, 400),
        _x("band.stage", "user_annotation", 10, 50),
        _x("op000_CONV_2D", "user_annotation", 60, 300),
        _x("band.window", "user_annotation", 500, 600),
        _x("band.request", "user_annotation", 0, 30, tid=2),
        _x("band.request", "user_annotation", 40, 20, tid=2),
        _x("band.retire", "kernel", 0, 999, tid=0),  # not a host span
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    got = {(thread, name): (ms, n) for ms, n, thread, name
           in X.host_spans(path)}
    assert got == pytest.approx({
        ("band-worker-0", "band.window"): (1.0, 2),
        ("band-worker-0", "band.stage"): (0.05, 1),
        ("tid 2", "band.request"): (0.05, 2)})
    assert X.host_spans(path)[0][2:] == ("band-worker-0", "band.window")
    assert X.main([path]) == 0
    out = capsys.readouterr().out
    assert "== by host span" in out and "band.request" in out
