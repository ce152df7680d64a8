"""The readers of the program's host spans and counters (``spans.py`` and
its nine metrics), on hand-made Chrome traces whose answers are known, on
a real CPU profile, and in a traced CPU run of a tiny cell."""

import types

import pytest

from portbench import harness, spans, spec
from portbench.tests.conftest import ROOT

NEW = ["request_us.stream", "plan_us.stream", "outputs_us.stream",
       "worker_wait.stream", "stage_ms.stream", "retire_ms.stream",
       "dispatch_cpu.stream", "pad_share.stream", "idle_in_dispatch.stream"]
WORKER, CALLER, PLANNER, RETIRE = 11, 12, 13, 14


def _x(name, cat, ts, dur, tid):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _annotation(name, ts, dur, tid=WORKER):
    return _x(name, "user_annotation", ts, dur, tid)


def _trace():
    """0-10,000 µs.  The worker: two windows (1,000-3,000, 6,000-7,000),
    a wait (3,000-6,000), two stages, three graph ops; the caller: two
    requests, two get_outputs; the planner: one pass; the retire thread:
    one retire with its wait and finish.  The card: busy 0-1,500,
    2,500-2,600 and 6,500-10,000, so idle 1,500-2,500, 2,600-6,500:
    4,900 µs, of it 1,000 + 400 + 500 in the windows."""
    return [
        _annotation("band.window", 1000, 2000),
        _annotation("band.stage", 1100, 300),
        _annotation("op000_CONV_2D", 1500, 500),
        _annotation("op001_ADD", 2000, 900),
        _annotation("band.wait", 3000, 3000),
        _annotation("band.window", 6000, 1000),
        _annotation("band.stage", 6100, 200),
        _annotation("op000_CONV_2D", 6300, 600),
        _annotation("op001_ADD", 0, 100, tid=CALLER),  # fewer graph ops
        _annotation("band.request", 0, 40, tid=CALLER),
        _annotation("band.request", 500, 60, tid=CALLER),
        _annotation("band.get_outputs", 8000, 150, tid=CALLER),
        _annotation("band.get_outputs", 9000, 250, tid=CALLER),
        _annotation("band.plan", 600, 90, tid=PLANNER),
        _annotation("band.retire", 7000, 2000, tid=RETIRE),
        _annotation("band.retire.wait", 7000, 1500, tid=RETIRE),
        _annotation("band.retire.finish", 8500, 400, tid=RETIRE),
        _x("aten::add", "cpu_op", 2000, 10, WORKER),
        _x("k1", "kernel", 0, 1000, 0),
        _x("k2", "kernel", 500, 1000, 0),  # overlaps k1
        _x("Memcpy HtoD", "gpu_memcpy", 2500, 100, 0),
        _x("k3", "kernel", 6500, 3500, 0),
        _x("band.window", "gpu_user_annotation", 1000, 9000, 0),
    ]


COUNTERS = dict(rows_stacked=64, rows_padded=8, dispatch_wall_ns=4_000_000,
                dispatch_cpu_ns=3_000_000)


@pytest.fixture
def program(monkeypatch):
    """A program whose last device trace is ``_trace()``."""
    kept = types.SimpleNamespace(profile=object(), counters=dict(COUNTERS))
    monkeypatch.setattr(spans, "program_trace", lambda: kept)
    monkeypatch.setattr(spans, "profile_events", lambda profile: _trace())
    return kept


def _run(requests=2, windows=None):
    return types.SimpleNamespace(trace=object(), trace_requests=requests,
                                 trace_windows=windows or {32: 1, 1: 1})


def test_summary_of_a_hand_made_trace():
    s = spans.summarize(_trace())
    assert s.worker == (1, WORKER)
    assert s.window_s == pytest.approx(0.01)
    assert s.seconds("band.window") == pytest.approx(0.003)
    assert s.seconds("band.stage", s.worker) == pytest.approx(0.0005)
    assert s.spans[((1, CALLER), "band.request")] == pytest.approx((1e-4, 2))
    assert s.idle_s == pytest.approx(0.0049)
    assert s.idle_in_window_s == pytest.approx(0.0019)


EXPECTED = {
    "request_us.stream": 50.0,  # 100 µs over 2 requests
    "plan_us.stream": 45.0,
    "outputs_us.stream": 200.0,
    "worker_wait.stream": 30.0,  # 3 ms of 10
    "stage_ms.stream": 0.25,  # 0.5 ms over 2 windows
    "retire_ms.stream": 0.2,
    "dispatch_cpu.stream": 75.0,
    "pad_share.stream": 12.5,
    "idle_in_dispatch.stream": 100.0 * 1.9 / 4.9,
}


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_hand_made_trace(metric, program):
    assert spec.reader(ROOT, metric)(_run()) == pytest.approx(
        EXPECTED[metric])


@pytest.mark.parametrize("metric", NEW)
def test_reader_of_a_program_without_spans(metric, monkeypatch):
    monkeypatch.setattr(spans, "program_trace", lambda: None)
    assert spec.reader(ROOT, metric)(_run()) is None


def test_idle_outside_every_window_reads_zero(monkeypatch):
    events = [_annotation("band.window", 0, 1000),
              _annotation("op000_ADD", 100, 800),
              _x("k", "kernel", 0, 1000, 0),
              _x("k", "kernel", 3000, 1000, 0),
              _annotation("band.wait", 1000, 2000)]
    s = spans.summarize(events)
    assert s.idle_s == pytest.approx(0.002)
    assert s.idle_in_window_s == 0.0
    kept = types.SimpleNamespace(profile=None, counters={})
    monkeypatch.setattr(spans, "program_trace", lambda: kept)
    monkeypatch.setattr(spans, "profile_events", lambda profile: events)
    assert spec.reader(ROOT, "idle_in_dispatch.stream")(_run()) == 0.0
    # no counters: the counter metrics are left out
    assert spec.reader(ROOT, "pad_share.stream")(_run()) is None
    assert spec.reader(ROOT, "dispatch_cpu.stream")(_run()) is None


class _Annotated:
    """A card event of a torch with user annotations marked but no
    activity types."""

    def __init__(self, name, annotation, start, end):
        self._name, self.annotation = name, annotation
        self.start, self.end = start, end

    def name(self):
        return self._name

    def device_type(self):
        import torch

        return torch._C._autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_card_busy_leaves_out_host_span_annotations():
    from portbench.trace import card_busy

    events = [_Annotated("qmatmul_kernel", False, 0, 4000),
              _Annotated("band.window", True, 0, 30000),
              _Annotated("band.stage", True, 0, 30000)]
    busy, kinds = card_busy(events)
    assert busy == pytest.approx(4e-6)
    assert kinds == {"kernel": 1}


def test_profile_events_of_a_cpu_session():
    import threading

    import torch

    from band_tpu_torch.tracing.spans import span

    def work():
        with span("band.window"):
            with span("op000_ADD"):
                torch.ones(4).add(1)

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    prof.stop()
    events = spans.profile_events(prof)
    by_name = {e["name"]: e for e in events}
    window, op = by_name["band.window"], by_name["op000_ADD"]
    assert window["cat"] == op["cat"] == "user_annotation"
    assert window["tid"] == op["tid"]
    assert window["ts"] <= op["ts"] and \
        op["ts"] + op["dur"] <= window["ts"] + window["dur"]
    s = spans.summarize(events)
    assert s.worker == (0, window["tid"])
    assert s.seconds("band.window", s.worker) == pytest.approx(
        window["dur"] / 1e6)


def test_a_traced_run_reports_the_span_metrics(tiny_root):
    r = harness.run_cell(tiny_root, "sr_tiny.stream_tiny", 2**31 + 21, 1.0,
                         True, "cpu", 0.0)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    # no device events on the CPU: no idle time to split
    for name in NEW[:-1]:
        assert name in got, (name, sorted(got))
    assert "idle_in_dispatch.stream" not in got
    assert got["request_us.stream"]["value"] > 0
    assert 0 < got["dispatch_cpu.stream"]["value"] <= 100.0
    assert 0 <= got["pad_share.stream"]["value"] < 100.0
