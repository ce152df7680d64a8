"""Mesh workers through the port's engine on the virtual CPU devices:
copies of tests/test_mesh_worker.py on tests/data models (its reference
models are absent here), and band_tpu's multi-chip dry run
(__graft_entry__.py dryrun_multichip) on tests/data models: two mesh
workers of different dp x tp shapes and a host worker under HEFT, a
continuation from one mesh through the host to the other, and a fault
injected mid-run and rerouted.  Outputs byte-equal to a single-device
worker's and to the TFLite goldens."""

import os

import numpy as np
import pytest
import torch

import band_tpu_torch as tb
from band_tpu_torch.backend.program import build_program, params_from_jax
from band_tpu_torch.ir.graph import Graph, OpNode, TensorDef
from band_tpu_torch.ops.host_ops import register_host_op
from band_tpu_torch.parallel.mesh import (ShardedProgram, make_batched_fn,
                                          make_mesh)
from band_tpu_torch.tflite.parser import parse_tflite_file
from band_tpu_torch.tflite.schema import TensorType
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SMALL = "effnetlite_int8"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tiny CPU ops: the test workers
    share the cores, and torch's thread pool on busy cores is far slower
    than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


def _goldens(name):
    z = np.load(GOLDENS_PATH)
    g = parse_tflite_file(_path(name))
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    return golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                         len(want)), want


def _cpu(ids, **kw):
    return tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=tuple(ids),
                         **kw)


def test_mesh_worker_equals_single_device():
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.FIXED_WORKER)
           .add_worker(_cpu((0, 1, 2, 3)))
           .add_worker(_cpu((4,)))
           .profile_warmups(0).profile_runs(1).build())
    eng = tb.Engine.create(cfg)
    try:
        mid = eng.register_model(tb.Model.from_path(_path(SMALL)))
        xs, want = _goldens(SMALL)
        for i, x in enumerate(xs[:2]):
            out_mesh = eng.request_sync(mid, [x],
                                        tb.RequestOption(target_worker=0))
            out_single = eng.request_sync(mid, [x],
                                          tb.RequestOption(target_worker=1))
            np.testing.assert_array_equal(out_mesh[0], out_single[0])
            np.testing.assert_array_equal(out_mesh[0], want[i])
    finally:
        eng.shutdown()


def test_sharded_program_collectives():
    """Direct ShardedProgram check: tp-sharded weights over 4 devices,
    dp-sharded batch over 2; the output must equal the unsharded
    program's."""
    g = parse_tflite_file(_path(SMALL))
    prog = build_program(g, range(len(g.ops)), exact=True)
    sp = ShardedProgram(prog, make_mesh(dp=2, tp=4))
    xs, _ = _goldens(SMALL)
    out = sp([torch.from_numpy(xs[:2].reshape((-1,) + xs.shape[2:]))])[0]
    fn = prog.make_fn()
    params = params_from_jax(prog.params)
    for b in range(2):
        ref = fn(params, [torch.from_numpy(xs[b])])[0]
        assert torch.equal(out[b:b + 1], ref)


def test_mesh_worker_batched_window_single_dispatch():
    """A mesh worker runs a 16-request continuous-batching window as ONE
    dispatch (batch split on "dp", weights on "tp"), with HEFT's
    global-queue stacking driving it."""
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME)
           .add_worker(_cpu((0, 1, 2, 3), mesh_shape=(2, 2), max_batch=16))
           .profile_warmups(0).profile_runs(1).build())
    eng = tb.Engine.create(cfg)
    calls = []
    orig = eng.invoke_batched

    def counting_invoke_batched(key, inputs_list):
        calls.append(len(inputs_list))
        return orig(key, inputs_list)

    eng.invoke_batched = counting_invoke_batched
    try:
        mid = eng.register_model(tb.Model.from_path(_path("fc_int8")))
        eng.wait_buckets_ready(timeout=120)
        rec = eng.model_record(mid)
        ex = rec.executors[0]
        assert ex.mesh.shape == {"dp": 2, "tp": 2}
        xs, want = _goldens("fc_int8")
        xs16 = np.concatenate([xs, xs[::-1]])
        ids = eng.request_async_batch([mid] * 16, [[x] for x in xs16])
        st = eng.wait_all(ids, timeout=120, raise_on_incomplete=True)
        assert all(s == tb.JobStatus.SUCCESS for s in st.values())
        for jid, i in zip(ids, list(range(8)) + list(range(7, -1, -1))):
            np.testing.assert_array_equal(eng.get_outputs(jid)[0], want[i])
        # the whole window rode one batched dispatch, not 16 serial ones,
        # and it ran as one launch sequence of 16 on the mesh
        assert max(calls) == 16, calls
        assert ex.windows[16] >= 1, ex.windows
    finally:
        eng.shutdown()


def test_mesh_batched_fn_matches_unsharded():
    """make_batched_fn equals per-request unsharded execution bit for bit
    (int8 model, dp=2 x tp=2)."""
    g = parse_tflite_file(_path(SMALL))
    prog = build_program(g, range(len(g.ops)), exact=True)
    mesh = make_mesh(dp=2, tp=2)
    sp = ShardedProgram(prog, mesh)
    fn = make_batched_fn(prog, mesh, batch=4)
    xs, want = _goldens(SMALL)
    outs = fn(sp.params, tuple((x,) for x in xs[:4]))
    ref_fn = prog.make_fn()
    params = params_from_jax(prog.params)
    for b, x in enumerate(xs[:4]):
        ref = ref_fn(params, [torch.from_numpy(x)])[0]
        assert torch.equal(outs[b][0], ref)
        np.testing.assert_array_equal(ref.numpy(), want[b])


@register_host_op("CUSTOM:DryrunPlusOne")
def _plus_one(graph, op, inputs):
    return [inputs[0] + 1.0]


def _chain() -> Graph:
    shape = (1, 8)
    tens = [
        TensorDef(0, "x", shape, TensorType.FLOAT32),
        TensorDef(1, "two", (1,), TensorType.FLOAT32,
                  data=np.asarray([2.0], np.float32)),
        TensorDef(2, "m", shape, TensorType.FLOAT32),
        TensorDef(3, "c", shape, TensorType.FLOAT32),
        TensorDef(4, "three", (1,), TensorType.FLOAT32,
                  data=np.asarray([3.0], np.float32)),
        TensorDef(5, "y", shape, TensorType.FLOAT32),
    ]
    ops = [
        OpNode(0, "MUL", [0, 1], [2], {"activation": "NONE"}),
        OpNode(1, "CUSTOM:DryrunPlusOne", [2], [3], {}),
        OpNode(2, "ADD", [3, 4], [5], {"activation": "NONE"}),
    ]
    return Graph(name="chain", tensors=tens, ops=ops, inputs=[0],
                 outputs=[5])


def test_dryrun_multichip_scenario():
    """Two mesh workers of different shapes (2x2 tp-heavy, 4x1 pure dp)
    and a host worker under HEFT: the three tests/data CNNs fired
    concurrently with SLOs and no pinning, a host-op chain cost-forced
    into a continuation mesh A -> host -> mesh B, at least three workers
    serving, and a fault injected on mesh A mid-run that the next wave
    reroutes around."""
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.HETEROGENEOUS_EARLIEST_FINISH_TIME)
           .add_worker(_cpu(range(4), mesh_shape=(2, 2), max_batch=2))
           .add_worker(_cpu(range(4, 8), mesh_shape=(4, 1), max_batch=2))
           .add_worker(_cpu((0,), max_batch=2))
           .minimum_subgraph_size(1)
           .profile_warmups(0).profile_runs(1).build())
    eng = tb.Engine.create(cfg)
    mesh_wids, host_wid = [0, 1], 2
    try:
        names = ["effnetlite_int8", "resnetish_int8", "fc_int8"]
        mids = [eng.register_model(tb.Model.from_path(_path(n)))
                for n in names]
        for wid, shape in zip(mesh_wids, [(2, 2), (4, 1)]):
            mesh = eng.model_record(mids[2]).executors[wid].mesh
            assert (mesh.shape["dp"], mesh.shape["tp"]) == shape
        eng.wait_buckets_ready(timeout=120)
        cid = eng.register_model(tb.Model(graph=_chain(), path="chain"))
        forbid_us = 100_000_000_000
        for key in eng.model_record(cid).subgraph_keys:
            u = key.unit_indices
            if key.worker_id == host_wid and u != frozenset([1]):
                eng.latency_estimator.override(key, forbid_us)
            if key.worker_id == mesh_wids[0] and 2 in u:
                eng.latency_estimator.override(key, forbid_us)
            if key.worker_id == mesh_wids[1] and 0 in u:
                eng.latency_estimator.override(key, forbid_us)
        slo = 600_000_000
        goldens = [_goldens(n) for n in names]
        models, inputs = [], []
        for mid, (xs, _) in zip(mids, goldens):
            models += [mid] * 4
            inputs += [[x] for x in xs[:4]]
        chain_x = np.random.default_rng(0).standard_normal(
            (1, 8)).astype(np.float32)
        models += [cid] * 2
        inputs += [[chain_x]] * 2
        ids = eng.request_async_batch(
            models, inputs, [tb.RequestOption(slo_us=slo)] * len(models))
        st = eng.wait_all(ids, timeout=300, raise_on_incomplete=True)
        assert all(s == tb.JobStatus.SUCCESS for s in st.values()), st
        for k, (xs, want) in enumerate(goldens):
            for i in range(4):
                np.testing.assert_array_equal(
                    eng.get_outputs(ids[4 * k + i])[0], want[i])
        np.testing.assert_allclose(eng.get_outputs(ids[-1])[0],
                                   chain_x * 2.0 + 1.0 + 3.0, rtol=1e-6)
        last_hop = eng.planner.get_finished_job(ids[-1])
        assert last_hop.resolved_unit_subgraphs, "not a continuation"
        assert last_hop.subgraph_key.worker_id == mesh_wids[1]
        used = {eng.planner.get_finished_job(j).subgraph_key.worker_id
                for j in ids}
        assert len(used) >= 3, used
        # a fault on mesh A: the next wave completes on the others
        eng.inject_fault(mesh_wids[0], 1)
        xs, want = goldens[0]
        ids2 = eng.request_async_batch(
            [mids[0]] * 4, [[x] for x in xs[:4]],
            [tb.RequestOption(slo_us=slo)] * 4)
        st2 = eng.wait_all(ids2, timeout=300, raise_on_incomplete=True)
        assert all(s == tb.JobStatus.SUCCESS for s in st2.values()), st2
        for i, jid in enumerate(ids2):
            np.testing.assert_array_equal(eng.get_outputs(jid)[0], want[i])
    finally:
        eng.shutdown()
