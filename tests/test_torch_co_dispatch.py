"""Co-dispatch on the port: several models' windows served as one
dispatch by a worker with ``co_dispatch > 1``, on CPU workers (where
the combined program is the members' programs run back to back; on a
card it is one CUDA graph, held by chip_smoke.py).

The contracts of tests/test_co_dispatch.py, on fc_int8, resnetish_int8
and effnetlite_int8 (band_tpu's file needs the absent add.tflite):
fused outputs equal solo outputs and the TFLite goldens byte for byte
(tolerance 0); a cold mix falls back to single windows and fuses after
the miss threshold; one-off mixes are not built; the latency update
charges each window its share; co_dispatch=1 never fuses; unregister
drops combos; a fault injected into a fused dispatch recovers.  And the
port's ``DeviceQueueWorker._dequeue_groups`` pops the same groups and
asks for the same signatures as band_tpu's on scripted queues."""

import os
import time
import types

import numpy as np
import pytest
import torch

import band_tpu.common as jcommon
import band_tpu.config as jconfig
import band_tpu.runtime.worker as jworker
import band_tpu_torch as tb
import band_tpu_torch.common as tcommon
import band_tpu_torch.config as tconfig
import band_tpu_torch.runtime.worker as tworker
from band_tpu_torch.backend import executor as texecutor
from band_tpu_torch.ops import kernels as K
from tests.mock_engine import MockEngine as JMock
from tests.test_torch_engine import _goldens
from tests.test_torch_schedulers import _torch_mock_engine

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MIX = ("fc_int8", "resnetish_int8", "effnetlite_int8")
WINDOW = 4


def _engine(co_dispatch, **spec):
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.FIXED_WORKER)
           .add_worker(tb.WorkerSpec(
               device=tb.DeviceFlag.CPU, device_ids=(0,), max_batch=WINDOW,
               co_dispatch=co_dispatch, dispatch_depth=4, **spec))
           .profile_warmups(0).profile_runs(1)
           .build())
    return tb.Engine.create(cfg)


def _register(eng, names=MIX):
    mids = [eng.register_model(
        tb.Model.from_path(os.path.join(DATA, f"{n}.tflite"))) for n in names]
    assert eng.wait_buckets_ready(timeout=120)
    return mids


@pytest.fixture
def mix():
    eng = _engine(co_dispatch=len(MIX))
    try:
        mids = _register(eng)
        yield eng, mids, [_goldens(n) for n in MIX]
    finally:
        eng.shutdown()


def _burst(eng, mids, gold, rounds):
    """Queue ``rounds`` interleaved full windows per model while the
    worker is paused (so the deque really holds the mix), then release.
    Returns [(job id, model index, golden request)]."""
    w = eng.workers[0]
    w.pause()
    jobs = []
    for r in range(rounds):
        for m, (mid, (xs, _)) in enumerate(zip(mids, gold)):
            reqs = [(r * WINDOW + i) % len(xs) for i in range(WINDOW)]
            ids = eng.request_async_batch([mid] * WINDOW,
                                          [[xs[i]] for i in reqs])
            jobs += [(j, m, i) for j, i in zip(ids, reqs)]
    time.sleep(0.1)
    w.resume()
    return jobs


def _all_succeed(eng, jobs):
    st = eng.wait_all([j for j, _, _ in jobs], timeout=120)
    assert len(st) == len(jobs)
    assert all(v == tb.JobStatus.SUCCESS for v in st.values()), st


def test_fused_windows_match_solo_and_goldens(mix):
    eng, mids, gold = mix
    solo = [[eng.request_sync(mid, [x]) for x in xs]
            for mid, (xs, _) in zip(mids, gold)]
    assert eng.warm_co_dispatch(mids, batch=WINDOW, timeout=120)
    sig = next(iter(eng._combo_fns))
    assert len(sig) == len(MIX) and all(b == WINDOW for _, b in sig)
    assert eng._combo_fns[sig].graph is None  # the CPU branch
    jobs = _burst(eng, mids, gold, rounds=3)
    _all_succeed(eng, jobs)
    assert eng.co_dispatch_count == 3
    for j, m, i in jobs:
        out = eng.get_outputs(j)
        assert len(out) == 1 and out[0].dtype == gold[m][1].dtype
        np.testing.assert_array_equal(out[0], solo[m][i][0])
        np.testing.assert_array_equal(out[0], gold[m][1][i])


def test_cold_mix_falls_back_to_single_windows(mix, monkeypatch):
    """Before the combo is built a mixed queue serves window by window;
    misses past the threshold schedule a background build, after which
    the same mix fuses."""
    eng, mids, gold = mix
    eng.co_warm_miss_threshold = 1
    w = eng.workers[0]
    single, dispatch = [], w._dispatch

    def spy(jobs, gen=None):
        single.append(eng.co_dispatch_count)
        return dispatch(jobs, gen)

    monkeypatch.setattr(w, "_dispatch", spy)
    jobs = _burst(eng, mids, gold, rounds=2)
    _all_succeed(eng, jobs)
    # the first window ran alone, before any fused dispatch
    assert single and single[0] == 0
    assert eng.wait_buckets_ready(timeout=120)
    assert "ready" in eng._combo_state.values()
    jobs = _burst(eng, mids, gold, rounds=2)
    _all_succeed(eng, jobs)
    assert eng.co_dispatch_count > 0
    for j, m, i in jobs:
        np.testing.assert_array_equal(eng.get_outputs(j)[0], gold[m][1][i])


def test_one_off_mixes_are_not_built(mix):
    eng, mids, gold = mix
    assert eng.co_warm_miss_threshold > 4
    jobs = _burst(eng, mids, gold, rounds=2)
    _all_succeed(eng, jobs)
    assert not eng._combo_state  # misses counted, nothing built
    assert eng._combo_misses
    assert eng.co_dispatch_count == 0


def test_latency_attribution_is_per_share(mix, monkeypatch):
    """Each window of a fused dispatch is charged its share of the
    measured time: the shares of one dispatch add up to 1, each below 1,
    and the latency update gets latency x share, not the whole time."""
    eng, mids, gold = mix
    assert eng.warm_co_dispatch(mids, batch=WINDOW, timeout=120)
    w = eng.workers[0]
    recs, charged = [], []
    dispatch_multi, update = w._dispatch_multi, eng.update_latency

    def spy_dispatch(groups, gen=None):
        out = dispatch_multi(groups, gen)
        recs.append(out)
        return out

    def spy_update(key, latency_us, batch=1):
        charged.append((key, latency_us, batch))
        update(key, latency_us, batch)

    monkeypatch.setattr(w, "_dispatch_multi", spy_dispatch)
    monkeypatch.setattr(eng, "update_latency", spy_update)
    jobs = _burst(eng, mids, gold, rounds=4)
    _all_succeed(eng, jobs)
    assert len(recs) == 4 and eng.co_dispatch_count == 4
    for dispatch in recs:
        assert len(dispatch) == len(MIX)
        shares = [r[3] for r in dispatch]
        assert sum(shares) == pytest.approx(1.0)
        assert all(0 < s < 1 for s in shares)
        assert len({id(r[2]) for r in dispatch}) == 1  # one event
        # every window is measured to the dispatch's one end stamp
        assert len({r[0][0].profiled_execution_time for r in dispatch}) == 1
        for jobs_, _, _, share in dispatch:
            full = jobs_[0].profiled_execution_time
            assert full > 0
            want = (jobs_[0].subgraph_key, max(int(full * share), 1),
                    WINDOW)
            assert want in charged
            assert want[1] < full
    for mid in mids:
        key = eng.get_largest_subgraph_key(mid, 0)
        assert eng.get_expected_latency(key, WINDOW) > 0


def test_co_dispatch_one_never_fuses():
    """co_dispatch=1 (the default) never fuses, not even a mix whose
    combined program is built, and counts no misses."""
    eng = _engine(co_dispatch=1)
    try:
        mids = _register(eng)
        gold = [_goldens(n) for n in MIX]
        assert eng.warm_co_dispatch(mids, batch=WINDOW, timeout=120)
        jobs = _burst(eng, mids, gold, rounds=3)
        _all_succeed(eng, jobs)
        assert eng.co_dispatch_count == 0
        assert not eng._combo_misses
    finally:
        eng.shutdown()


def test_unregister_drops_combos(mix):
    eng, mids, gold = mix
    assert eng.warm_co_dispatch(mids, batch=WINDOW, timeout=120)
    assert eng.warm_co_dispatch(mids[:2], batch=2, timeout=120)
    assert len(eng._combo_state) == 2
    eng.unregister_model(mids[2])
    assert len(eng._combo_state) == 1
    for table in (eng._combo_state, eng._combo_fns, eng._combo_misses):
        assert not any(k.model_id == mids[2] for sig in table for k, _ in sig)
    xs, want = gold[0]
    np.testing.assert_array_equal(eng.request_sync(mids[0], [xs[0]])[0],
                                  want[0])


def test_fault_in_fused_dispatch_recovers(mix, monkeypatch):
    """An injected fault makes the first fused dispatch raise
    ExecutionError: its jobs requeue, the worker probes and comes back,
    and every request ends, byte-equal to the goldens."""
    eng, mids, gold = mix
    assert eng.warm_co_dispatch(mids, batch=WINDOW, timeout=120)
    eng.workers[0]._avail_check_ms = 20
    raised = []
    invoke_multi = eng.invoke_multi

    def spy(sig, groups):
        try:
            return invoke_multi(sig, groups)
        except tb.ExecutionError:
            raised.append(sig)
            raise

    monkeypatch.setattr(eng, "invoke_multi", spy)
    eng.inject_fault(worker_id=0, count=1)
    jobs = _burst(eng, mids, gold, rounds=3)
    _all_succeed(eng, jobs)
    assert len(raised) == 1
    for j, m, i in jobs:
        np.testing.assert_array_equal(eng.get_outputs(j)[0], gold[m][1][i])


def test_combo_input_checks_and_cpu_fill():
    """A static buffer takes only requests of its shape and type (a
    replay runs no wrapper checks); a window of device tensors fills it
    with one concatenation."""
    static = torch.zeros((4, 2, 3), dtype=torch.int8)
    with pytest.raises(tb.ExecutionError, match="static buffer"):
        texecutor._fill(static, [np.zeros((1, 2, 3), np.uint8)] * 4, 4)
    with pytest.raises(tb.ExecutionError, match="static buffer"):
        texecutor._fill(static, [torch.zeros((2, 2, 3), dtype=torch.int8)] * 4, 4)
    col = [torch.full((1, 2, 3), i, dtype=torch.int8) for i in range(4)]
    texecutor._fill(static, col, 4)
    assert static[:, 0, 0].tolist() == [0, 1, 2, 3]
    with pytest.raises(tb.ExecutionError, match="window of 5"):
        texecutor._pad([[0]] * 5, 4)


def test_capture_tallies_kernel_calls_for_replays():
    """Kernel calls made while this thread captures a graph are tallied,
    not counted; each replay adds the tally."""
    c = K.LAUNCHES["qmatmul_exact"]
    c.reset()
    with K.recording() as tally:
        c.add()
        c.add()
    assert c.n == 0 and tally == {"qmatmul_exact": 2}
    K.add_launches(tally)
    K.add_launches(tally)
    assert c.n == 4
    c.reset()


def test_bucket_of_matches_band_tpu():
    """One bucket rule for the executor, the latency table, the worker's
    signatures and warm_co_dispatch: band_tpu's."""
    from band_tpu.runtime.latency_estimator import bucketize

    assert [tcommon.bucket_of(b) for b in range(0, 70)] == [
        bucketize(b) for b in range(0, 70)]


# ----------------------------------------------------------------------
# _dequeue_groups against band_tpu's on scripted queues
# ----------------------------------------------------------------------
PKGS = {
    "band_tpu": types.SimpleNamespace(c=jcommon, cfg=jconfig, w=jworker,
                                      Mock=JMock),
    "band_tpu_torch": types.SimpleNamespace(c=tcommon, cfg=tconfig,
                                            w=tworker,
                                            Mock=_torch_mock_engine()),
}

# (co_dispatch, max_batch, queue of model ids, models whose buckets are
# still warming (ready limit 2), signatures that are ready)
SCRIPTS = {
    "fuse_three": (3, 4, [0, 0, 1, 1, 1, 2, 0], (), "all"),
    "cold_mix": (3, 4, [0, 1, 2, 0, 1, 2], (), ()),
    "limit_two": (2, 4, [2, 2, 0, 1, 1, 1, 1, 1], (), "all"),
    "co_dispatch_one": (1, 4, [0, 1, 2], (), "all"),
    "repeat_key_stops": (4, 2, [1, 0, 1, 2, 2, 2], (), "all"),
    "warming_cap": (3, 8, [0, 1, 1, 1, 1, 2, 2], (1,), "all"),
    "partial_ready": (3, 4, [0, 1, 2, 2, 1, 0], (), {(0, 1)}),
}


def _run_script(pkg, script):
    p = PKGS[pkg]
    co, max_batch, queue, warming, ready = script
    eng = p.Mock(num_workers=1)
    asked = []

    def co_dispatch_ready(sig):
        asked.append(tuple((k.model_id, b) for k, b in sig))
        return ready == "all" or tuple(k.model_id for k, _ in sig) in ready

    eng.co_dispatch_ready = co_dispatch_ready
    eng.ready_batch_limit = lambda key: (
        2 if key.model_id in warming else 1 << 30)
    spec = p.cfg.WorkerSpec(device=p.c.DeviceFlag.CPU, device_ids=(0,),
                            max_batch=max_batch, co_dispatch=co)
    w = p.w.DeviceQueueWorker(eng, 0, spec)
    for i, mid in enumerate(queue):
        job = p.c.Job(model_id=mid)
        job.job_id = i
        job.subgraph_key = p.c.SubgraphKey(mid, 0, frozenset([0]))
        w._queue.append(job)
    popped = []
    while w._queue:
        groups = w._dequeue_groups()
        popped.append([[j.job_id for j in g] for g in groups])
    return popped, asked


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_dequeue_groups_matches_band_tpu(name):
    got = {pkg: _run_script(pkg, SCRIPTS[name]) for pkg in PKGS}
    assert got["band_tpu_torch"] == got["band_tpu"]
    popped, asked = got["band_tpu_torch"]
    # every queued job popped once, in queue order within each window
    assert sorted(j for d in popped for g in d for j in g) == list(
        range(len(SCRIPTS[name][2])))
    fused = [d for d in popped if len(d) > 1]
    assert bool(fused) == (name in FUSING), popped
    assert all(len(s) > 1 for s in asked)


FUSING = {"fuse_three", "limit_two", "repeat_key_stops", "warming_cap",
          "partial_ready"}
