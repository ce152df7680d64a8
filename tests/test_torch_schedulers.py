"""The port's schedulers against band_tpu's on scripted cases.

Every scripted case of tests/test_schedulers.py (plus the HEFT-reserved,
fixed-worker global-queue and global-queue batching cases) runs twice:
on band_tpu's schedulers over tests/mock_engine.py, and on the port's
schedulers over the same mock engine built on the port's own
``EngineBase``, ``Job`` and ``SubgraphKey`` (the mock's source, its
imports pointed at band_tpu_torch).  The actions (job, worker, units,
batch), the jobs left queued and the jobs finished with their statuses
must be equal, and each case's own expectation holds on the port."""

import collections
import os
import types

import pytest

import band_tpu.common as jcommon
import band_tpu_torch.common as tcommon
from band_tpu.schedulers.fixed_worker import (
    FixedWorkerGlobalQueueScheduler as JFixedGQ,
    FixedWorkerScheduler as JFixed,
)
from band_tpu.schedulers.heft import HEFTScheduler as JHEFT
from band_tpu.schedulers.least_slack_first import (
    LeastSlackFirstScheduler as JLSF,
)
from band_tpu.schedulers.round_robin import RoundRobinScheduler as JRR
from band_tpu.schedulers.shortest_expected_latency import (
    ShortestExpectedLatencyScheduler as JSEL,
)
from band_tpu_torch.schedulers import (
    FixedWorkerGlobalQueueScheduler as TFixedGQ,
    FixedWorkerScheduler as TFixed,
    HEFTScheduler as THEFT,
    LeastSlackFirstScheduler as TLSF,
    RoundRobinScheduler as TRR,
    ShortestExpectedLatencyScheduler as TSEL,
)
from tests.mock_engine import MockEngine as JMock

MOCK_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mock_engine.py")


def _torch_mock_engine():
    """tests/mock_engine.py's MockEngine on the port's EngineBase, Job
    and SubgraphKey."""
    with open(MOCK_SRC) as f:
        src = f.read()
    src = src.replace("from band_tpu.", "from band_tpu_torch.")
    assert "band_tpu." not in src.replace("band_tpu_torch.", "")
    mod = types.ModuleType("torch_mock_engine")
    exec(compile(src, MOCK_SRC, "exec"), mod.__dict__)
    return mod.MockEngine


PKGS = {
    "band_tpu": types.SimpleNamespace(
        c=jcommon, Mock=JMock, Fixed=JFixed, FixedGQ=JFixedGQ, RR=JRR,
        SEL=JSEL, HEFT=JHEFT, LSF=JLSF),
    "band_tpu_torch": types.SimpleNamespace(
        c=tcommon, Mock=_torch_mock_engine(), Fixed=TFixed,
        FixedGQ=TFixedGQ, RR=TRR, SEL=TSEL, HEFT=THEFT, LSF=TLSF),
}


def make_queue(*jobs):
    return collections.deque(jobs)


def _key(k):
    return (k.model_id, k.worker_id, tuple(sorted(k.unit_indices)))


def _record(eng, actions, queue):
    return dict(
        actions=[(j.job_id, _key(k), j.batch_size) for j, k in actions],
        queued=[j.job_id for j in queue],
        finished=[(j.job_id, j.status.name) for j in eng.finished],
    )


# --- the scripted cases: each returns (record, its own expectation) -----

def fixed_worker_uses_model_assignment(p):
    eng = p.Mock(num_workers=3)
    eng.model_workers = {0: 2}
    eng.latency[eng.whole_key(0, 2)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1))
    actions = p.Fixed(eng).schedule(q)
    ok = len(actions) == 1 and actions[0][1].worker_id == 2 and not q
    return _record(eng, actions, q), ok


def fixed_worker_explicit_target_wins(p):
    eng = p.Mock(num_workers=3)
    eng.model_workers = {0: 2}
    eng.latency[eng.whole_key(0, 1)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1, target_worker_id=1))
    actions = p.Fixed(eng).schedule(q)
    return _record(eng, actions, q), actions[0][1].worker_id == 1


def round_robin_spreads_across_idle_workers(p):
    eng = p.Mock(num_workers=2)
    for w in range(2):
        eng.latency[eng.whole_key(0, w)] = 100
        eng.latency[eng.whole_key(1, w)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1),
                   p.c.Job(model_id=1, job_id=2))
    actions = p.RR(eng).schedule(q)
    ok = (len(actions) == 2 and not q
          and {k.worker_id for _, k in actions} == {0, 1})
    return _record(eng, actions, q), ok


def round_robin_skips_busy_workers(p):
    eng = p.Mock(num_workers=2)
    eng.idle_workers = [1]
    for w in range(2):
        eng.latency[eng.whole_key(0, w)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1),
                   p.c.Job(model_id=0, job_id=2))
    actions = p.RR(eng).schedule(q)
    ok = len(actions) == 1 and actions[0][1].worker_id == 1 and len(q) == 1
    return _record(eng, actions, q), ok


def sel_picks_fastest_worker_and_books_time(p):
    eng = p.Mock(num_workers=2)
    eng.latency[eng.whole_key(0, 0)] = 1000
    eng.latency[eng.whole_key(0, 1)] = 200
    q = make_queue(p.c.Job(model_id=0, job_id=1),
                   p.c.Job(model_id=0, job_id=2))
    actions = p.SEL(eng).schedule(q)
    ok = len(actions) == 2 and [k.worker_id for _, k in actions] == [1, 1]
    return _record(eng, actions, q), ok


def sel_balances_when_queues_fill(p):
    eng = p.Mock(num_workers=2)
    eng.latency[eng.whole_key(0, 0)] = 300
    eng.latency[eng.whole_key(0, 1)] = 200
    q = make_queue(*[p.c.Job(model_id=0, job_id=i) for i in range(4)])
    actions = p.SEL(eng).schedule(q)
    by_worker = collections.Counter(k.worker_id for _, k in actions)
    return _record(eng, actions, q), by_worker[1] >= 2 and by_worker[0] >= 1


def heft_only_dispatches_to_idle(p):
    eng = p.Mock(num_workers=2)
    eng.idle_workers = [0]
    eng.latency[eng.whole_key(0, 0)] = 300
    eng.latency[eng.whole_key(0, 1)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1))
    actions = p.HEFT(eng).schedule(q)
    return _record(eng, actions, q), actions == [] and len(q) == 1


def heft_dispatches_when_best_idle(p):
    eng = p.Mock(num_workers=2)
    eng.latency[eng.whole_key(0, 0)] = 300
    eng.latency[eng.whole_key(0, 1)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1))
    actions = p.HEFT(eng).schedule(q)
    return (_record(eng, actions, q),
            len(actions) == 1 and actions[0][1].worker_id == 1)


def lsf_orders_by_slack_and_drops_expired(p):
    eng = p.Mock(num_workers=1)
    eng.latency[eng.whole_key(0, 0)] = 100
    eng.latency[eng.whole_key(1, 0)] = 100
    # test_schedulers.py's SLOs of 500 µs and 50 ms, scaled to 2 s and
    # 200 s: a loaded test machine can take 500 µs between building the
    # jobs and scheduling them, and the tight job would expire as well
    now = p.c.now_us()
    tight = p.c.Job(model_id=0, job_id=1, slo_us=2_000_000)
    tight.enqueue_time = now
    loose = p.c.Job(model_id=1, job_id=2, slo_us=200_000_000)
    loose.enqueue_time = now
    expired = p.c.Job(model_id=0, job_id=3, slo_us=10)
    expired.enqueue_time = now - 1000
    q = make_queue(loose, expired, tight)
    actions = p.LSF(eng).schedule(q)
    ok = ([j.job_id for j in eng.finished] == [3]
          and eng.finished[0].status == p.c.JobStatus.SLO_VIOLATION
          and len(actions) == 1 and actions[0][0].job_id == 1)
    return _record(eng, actions, q), ok


def sel_multi_hop_uses_resolved_units(p):
    eng = p.Mock(num_workers=2, num_units_per_model={0: 2})
    k01 = p.c.SubgraphKey(0, 0, frozenset([0]))
    k11 = p.c.SubgraphKey(0, 1, frozenset([1]))
    eng.latency[k01] = 100
    eng.latency[k11] = 100
    job = p.c.Job(model_id=0, job_id=1)
    job.resolved_unit_subgraphs = frozenset([0])
    q = make_queue(job)
    actions = p.SEL(eng).schedule(q)
    return _record(eng, actions, q), len(actions) == 1 and \
        actions[0][1] == k11


def heft_reserved_books_future_hops(p):
    """A two-unit model with its second unit only on worker 1: the
    reserved variant books the second hop on worker 1, so the next job
    sees it busy."""
    eng = p.Mock(num_workers=2, num_units_per_model={0: 2, 1: 1})
    eng.latency[p.c.SubgraphKey(0, 0, frozenset([0]))] = 100
    eng.latency[p.c.SubgraphKey(0, 1, frozenset([1]))] = 400
    eng.latency[eng.whole_key(1, 0)] = 300
    eng.latency[eng.whole_key(1, 1)] = 250
    q = make_queue(p.c.Job(model_id=0, job_id=1),
                   p.c.Job(model_id=1, job_id=2))
    actions = p.HEFT(eng, reserve=True).schedule(q)
    ok = ([(j.job_id, k.worker_id) for j, k in actions] == [(2, 1), (1, 0)]
          and not q)
    return _record(eng, actions, q), ok


def fixed_worker_global_queue_waits_for_idle(p):
    eng = p.Mock(num_workers=2)
    eng.idle_workers = [1]
    eng.model_workers = {0: 0, 1: 1}
    for m in range(2):
        for w in range(2):
            eng.latency[eng.whole_key(m, w)] = 100
    q = make_queue(p.c.Job(model_id=0, job_id=1),
                   p.c.Job(model_id=1, job_id=2),
                   p.c.Job(model_id=1, job_id=3))
    actions = p.FixedGQ(eng).schedule(q)
    ok = [j.job_id for j, _ in actions] == [2] and len(q) == 2
    return _record(eng, actions, q), ok


def heft_stacks_a_global_queue_window(p):
    """Same-model jobs stacked onto the claimed idle worker as one
    batched window, priced at the bucket's cost."""
    eng = p.Mock(num_workers=2)
    eng.batch_latency = {}
    eng.latency[eng.whole_key(0, 0)] = 300
    eng.latency[eng.whole_key(0, 1)] = 100
    eng.batch_latency[(eng.whole_key(0, 1), 4)] = 160
    eng.get_worker_batch_limit = lambda w: 4
    eng.ready_batch_limit = lambda key: 1 << 30
    q = make_queue(*[p.c.Job(model_id=0, job_id=i) for i in range(5)])
    actions = p.HEFT(eng).schedule(q)
    ok = (len(actions) == 4 and {k.worker_id for _, k in actions} == {1}
          and {j.batch_size for j, _ in actions} == {4} and len(q) == 1)
    return _record(eng, actions, q), ok


def lsf_fills_idle_workers_by_slack(p):
    """Two idle workers, three SLO jobs: the two with the least slack
    go first, each to the worker of its shortest path."""
    eng = p.Mock(num_workers=2)
    eng.latency[eng.whole_key(0, 0)] = 5000
    eng.latency[eng.whole_key(0, 1)] = 4000
    now = p.c.now_us()
    jobs = []
    for jid, slo in ((7, 2_000_000), (8, 200_000_000), (9, 4_000_000)):
        j = p.c.Job(model_id=0, job_id=jid, slo_us=slo)
        j.enqueue_time = now
        jobs.append(j)
    q = make_queue(*jobs)
    actions = p.LSF(eng).schedule(q)
    ok = ([j.job_id for j, _ in actions] == [7, 9]
          and [k.worker_id for _, k in actions] == [1, 0]
          and [j.job_id for j in q] == [8])
    return _record(eng, actions, q), ok


CASES = {f.__name__: f for f in (
    fixed_worker_uses_model_assignment,
    fixed_worker_explicit_target_wins,
    round_robin_spreads_across_idle_workers,
    round_robin_skips_busy_workers,
    sel_picks_fastest_worker_and_books_time,
    sel_balances_when_queues_fill,
    heft_only_dispatches_to_idle,
    heft_dispatches_when_best_idle,
    lsf_orders_by_slack_and_drops_expired,
    sel_multi_hop_uses_resolved_units,
    heft_reserved_books_future_hops,
    fixed_worker_global_queue_waits_for_idle,
    heft_stacks_a_global_queue_window,
    lsf_fills_idle_workers_by_slack,
)}


def test_torch_mock_engine_is_built_on_the_port():
    Mock = PKGS["band_tpu_torch"].Mock
    from band_tpu_torch.runtime.engine_interface import EngineBase

    assert issubclass(Mock, EngineBase)
    eng = Mock(num_workers=1)
    assert isinstance(eng.whole_key(0, 0), tcommon.SubgraphKey)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedulers_act_alike(case):
    ref, ref_ok = CASES[case](PKGS["band_tpu"])
    got, got_ok = CASES[case](PKGS["band_tpu_torch"])
    assert ref_ok, f"{case}: band_tpu's expectation"
    assert got_ok, f"{case}: the port's expectation"
    assert got == ref
