"""Heterogeneous serving in the port: a non-host worker plus a host
(CPU) worker under every scheduler, with custom ops on the host.

On this CPU-only machine the non-host worker is a GPU-flagged worker
that the test itself resolves to the CPU (it monkeypatches
``band_tpu_torch.runtime.engine.resolve_device``: the caller asking for
the CPU); nothing in the package does that on its own.

- ``ssd_int8`` and ``ssd_regular_int8`` (the SSD head ends in
  ``CUSTOM:TFLite_Detection_PostProcess``) served under SEL, HEFT and
  LSF give band_tpu's outputs on the same inputs byte for byte
  (band_tpu's engine on the CPU, a TPU-flagged worker plus a CPU
  worker, as in tests/test_fallback_chain.py), with the units split
  around the custom op and the custom op only on the host worker.
- ``resnetish_int8`` under every scheduler gives the TFLite goldens.
- The port's copy of ``host_ops`` gives band_tpu's detections on random
  detector inputs."""

import os

import numpy as np
import pytest
import torch

import band_tpu as jb
import band_tpu_torch as tb
from band_tpu.ops import host_ops as jhost
from band_tpu_torch.ops import host_ops as thost
from band_tpu_torch.runtime import engine as teng
from band_tpu_torch.tflite.parser import parse_tflite_file
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs
from tests.gen_torch_hetero_goldens import (
    HETERO_GOLDENS_PATH,
    MODELS as HETERO_SEEDS,
    hetero_inputs,
    input_sha,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SSD_MODELS = ("ssd_int8", "ssd_regular_int8")
POST = "CUSTOM:TFLite_Detection_PostProcess"
N_REQUESTS = 4


@pytest.fixture
def gpu_as_cpu(monkeypatch):
    """The caller asks for the CPU: GPU-flagged workers resolve to it."""
    real = teng.resolve_device

    def resolve(spec):
        if spec.device == tb.DeviceFlag.GPU:
            return torch.device("cpu")
        return real(spec)

    monkeypatch.setattr(teng, "resolve_device", resolve)


def _config(pkg, scheduler, accel_batch=4):
    accel = tb.DeviceFlag.GPU if pkg is tb else jb.DeviceFlag.TPU
    return (pkg.RuntimeConfigBuilder()
            .add_scheduler(scheduler)
            .add_worker(pkg.WorkerSpec(device=accel, device_ids=(0,),
                                       max_batch=accel_batch))
            .add_worker(pkg.WorkerSpec(device=pkg.DeviceFlag.CPU,
                                       device_ids=(1,), max_batch=1))
            .minimum_subgraph_size(1)
            .subgraph_preparation_type(
                pkg.SubgraphPreparationType.MERGE_UNIT_SUBGRAPH)
            .profile_warmups(1).profile_runs(1)
            .build())


def _ssd_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
            for _ in range(N_REQUESTS)]


@pytest.fixture(scope="module")
def band_tpu_ssd_outputs():
    """band_tpu's outputs for every SSD model and request (SEL; its
    outputs do not depend on the scheduler)."""
    out = {}
    eng = jb.Engine.create(
        _config(jb, jb.SchedulerType.SHORTEST_EXPECTED_LATENCY))
    try:
        for name in SSD_MODELS:
            mid = eng.register_model(
                jb.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
            out[name] = [eng.request_sync(mid, [x], timeout=120)
                         for x in _ssd_inputs()]
    finally:
        eng.shutdown()
    return out


def _custom_units(rec):
    g = rec.model.graph
    post = [op.index for op in g.ops if op.opname == POST]
    assert len(post) == 1
    return {u for u, ops in enumerate(rec.spec.unit_subgraph_ops)
            if post[0] in ops}


@pytest.mark.parametrize("name", SSD_MODELS)
@pytest.mark.parametrize("sched", [
    "SHORTEST_EXPECTED_LATENCY", "HETEROGENEOUS_EARLIEST_FINISH_TIME",
    "LEAST_SLACK_TIME_FIRST"])
def test_ssd_across_workers_equals_band_tpu(name, sched, gpu_as_cpu,
                                            band_tpu_ssd_outputs):
    eng = tb.Engine.create(_config(tb, getattr(tb.SchedulerType, sched)))
    try:
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
        rec = eng.model_record(mid)
        # the analyzer split the graph around the custom op: a backbone
        # unit every worker runs, then the detection unit only the host
        # worker runs
        custom = _custom_units(rec)
        assert rec.spec.num_unit_subgraphs == 2 and custom == {1}
        assert rec.spec.unsupported_ops[0] == {
            op.index for op in rec.model.graph.ops if op.opname == POST}
        assert rec.spec.unsupported_ops[1] == set()
        by_worker = {}
        for key in rec.subgraph_keys:
            by_worker.setdefault(key.worker_id, set()).add(
                tuple(sorted(key.unit_indices)))
            if key.unit_indices & custom:
                assert key.worker_id == 1, key
        assert by_worker[0] == {(0,)}
        assert by_worker[1] == {(0,), (1,), (0, 1)}
        assert not rec.executors[0].host and rec.executors[1].host

        xs = _ssd_inputs()
        want = band_tpu_ssd_outputs[name]
        got = [eng.request_sync(mid, [x], timeout=120) for x in xs]
        ids = [eng.request_async(mid, [x]) for x in xs]
        got += [eng.wait(j, timeout=120) for j in ids]
        for i, outs in enumerate(got):
            ref = want[i % N_REQUESTS]
            assert len(outs) == len(ref) == 4
            for a, b in zip(outs, ref):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        # every finished job ended on the host worker, which ran the
        # detection unit
        for j in ids:
            job = eng.planner.get_finished_job(j)
            assert job.subgraph_key.worker_id == 1
            assert job.subgraph_key.unit_indices & custom
        assert eng.get_model_execution_counts()[mid] == 2 * N_REQUESTS
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", SSD_MODELS)
def test_ssd_goldens_across_workers(name, gpu_as_cpu):
    """The card's SSD goldens (tests/gen_torch_hetero_goldens.py): the
    inputs regenerate from their seed, HEFT across both workers gives
    every golden output byte for byte, and each request's backbone output
    is byte for byte TFLite's detector input (``<name>/head``)."""
    z = np.load(HETERO_GOLDENS_PATH)
    xs = hetero_inputs(HETERO_SEEDS[name])
    assert int(z[f"{name}/seed"]) == HETERO_SEEDS[name]
    assert str(z[f"{name}/input_sha"]) == input_sha(xs)
    eng = tb.Engine.create(_config(
        tb, tb.SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME))
    try:
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
        # the host worker's backbone priced out of reach: every request
        # runs its backbone on worker 0 and hops to the host worker
        for key in eng.model_record(mid).subgraph_keys:
            if key.worker_id == 1 and 0 in key.unit_indices:
                eng.latency_estimator.override(key, 10**9)
        ids = [eng.request_async(mid, [x]) for x in xs]
        for i, j in enumerate(ids):
            for k, out in enumerate(eng.wait(j, timeout=120)):
                np.testing.assert_array_equal(out, z[f"{name}/output{k}"][i])
        # a continuation's input is the backbone's output as the other
        # worker made it: byte for byte TFLite's detector input
        graph = eng.model_record(mid).model.graph
        head = next(op.inputs[0] for op in graph.ops if op.opname == POST)
        for i, j in enumerate(ids):
            job = eng.planner.get_finished_job(j)
            assert job.subgraph_key.worker_id == 1
            assert job.resolved_unit_subgraphs == {0}
            got = job.activations[head].numpy()
            want = z[f"{name}/head"][i]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
    finally:
        eng.shutdown()


def test_custom_op_is_refused_off_the_host():
    from band_tpu_torch.backend.program import build_program
    from band_tpu_torch.errors import LoweringError

    g = parse_tflite_file(os.path.join(DATA, "ssd_int8.tflite"))
    with pytest.raises(LoweringError, match="host workers"):
        build_program(g, range(len(g.ops)))
    prog = build_program(g, range(len(g.ops)), host=True)
    assert prog.has_custom
    assert not build_program(g, range(len(g.ops) - 1)).has_custom


def _goldens(name):
    z = np.load(GOLDENS_PATH)
    g = tb.Model.from_path(os.path.join(DATA, f"{name}.tflite")).graph
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    return golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                         len(want)), want


@pytest.mark.parametrize("sched", [s.name for s in tb.SchedulerType])
def test_resnetish_under_each_scheduler(sched, gpu_as_cpu):
    xs, want = _goldens("resnetish_int8")
    eng = tb.Engine.create(_config(tb, getattr(tb.SchedulerType, sched)))
    try:
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, "resnetish_int8.tflite")))
        assert eng.wait_buckets_ready(timeout=120)
        for i in range(3):
            np.testing.assert_array_equal(
                eng.request_sync(mid, [xs[i]], timeout=60)[0], want[i])
        ids = [eng.request_async(mid, [xs[i % len(xs)]]) for i in range(10)]
        for i, j in enumerate(ids):
            np.testing.assert_array_equal(eng.wait(j, timeout=60)[0],
                                          want[i % len(xs)])
        assert eng.get_model_execution_counts()[mid] == 13
    finally:
        eng.shutdown()


def _detector_inputs(rng, n_anchors, n_classes):
    boxes = rng.standard_normal((1, n_anchors, 4)).astype(np.float32)
    scores = rng.random((1, n_anchors, n_classes + 1)).astype(np.float32)
    # some scores tie exactly and some sit below the threshold
    scores[0, ::7] = scores[0, 3]
    yx = rng.random((n_anchors, 2)).astype(np.float32)
    hw = (0.05 + 0.5 * rng.random((n_anchors, 2))).astype(np.float32)
    anchors = np.concatenate([yx, hw], axis=1)
    return [boxes, scores, anchors]


@pytest.mark.parametrize("name", SSD_MODELS)
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_classes_per_detection", [1, 2])
def test_host_ops_copy_gives_band_tpu_detections(name, seed,
                                                 max_classes_per_detection):
    g = parse_tflite_file(os.path.join(DATA, f"{name}.tflite"))
    op = next(o for o in g.ops if o.opname == POST)
    op.options = dict(op.options,
                      max_classes_per_detection=max_classes_per_detection,
                      nms_score_threshold=0.3)
    rng = np.random.default_rng(seed)
    ins = _detector_inputs(rng, n_anchors=int(rng.integers(20, 200)),
                           n_classes=int(op.options["num_classes"]))
    assert thost.has_host_impl(POST) and jhost.has_host_impl(POST)
    got = thost.run_host_op(POST, g, op, [a.copy() for a in ins])
    want = jhost.run_host_op(POST, g, op, [a.copy() for a in ins])
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3][0] > 0  # something was detected


def test_lsf_drops_a_request_whose_slo_no_worker_meets(gpu_as_cpu):
    xs, want = _goldens("resnetish_int8")
    eng = tb.Engine.create(_config(tb, tb.SchedulerType.LEAST_SLACK_TIME_FIRST))
    try:
        mid = eng.register_model(
            tb.Model.from_path(os.path.join(DATA, "resnetish_int8.tflite")))
        jid = eng.request_async(mid, [xs[0]], tb.RequestOption(slo_us=1))
        assert eng.wait_all([jid], timeout=60)[jid] == \
            tb.JobStatus.SLO_VIOLATION
        with pytest.raises(tb.DeadlineExceeded):
            eng.request_sync(mid, [xs[0]], tb.RequestOption(slo_us=1))
        # a meetable SLO is served
        np.testing.assert_array_equal(
            eng.request_sync(mid, [xs[1]],
                             tb.RequestOption(slo_us=60_000_000))[0], want[1])
    finally:
        eng.shutdown()
