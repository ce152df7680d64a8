"""WHILE, IF, the TensorArray write and the Keras 3 loops in the port, on
the CPU.

- while_loop, cond (both branches), gru_seq_while and lstm_seq_while as
  whole programs of the port against TFLite and band_tpu on seeded
  inputs, with tests/test_control_flow.py's tolerances (while_loop and
  cond rtol 1e-5, atol 1e-6; the Keras loops rtol 2e-5, atol 2e-6);
- cond in a window of mixed flags (a per-request predicate: both
  branches, selected per request) equal to each request alone and to
  band_tpu's program under jax.vmap, within the cond tolerance (the CPU's
  GEMM may round a row of a window's product differently from the same
  row alone, by an ulp);
- the IMDB bidirectional-LSTM network at T=6, vocabulary 50, width 4
  (tests/gen_torch_seq_models.py), fused and as WHILE loops, on seeded
  reviews: each against TFLite (a fresh interpreter for each request:
  its LSTM keeps state between invoke() calls) and band_tpu, and the two
  conversions against each other (rtol 2e-5, atol 2e-6); both served
  through the engine on a CPU worker, sync and in a burst of windows,
  equal to the program's own outputs;
- while_data_dep, whose trip count depends on the request's data, in
  windows of 1-8 requests (trip counts 0 to 16): equal to each request
  alone, to band_tpu's program under jax.vmap and to TFLite (rtol 1e-5,
  atol 1e-6; the counter exactly);
- a dynamic-begin SLICE with static sizes in a window of per-request
  begins (out of range ones clamped) equal to band_tpu's vmapped
  lax.dynamic_slice (tolerance 0), and a dynamic-size SLICE used outside
  the TensorArray write refused with band_tpu's error;
- the ``capturable`` flag, build_combo's refusal of a WHILE program, and
  a co-dispatch worker serving a WHILE model's windows unfused (counted);
- the TF32 rule reaching the FULLY_CONNECTED inside a loop body.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

import band_tpu_torch as tb
from band_tpu.backend.program import build_program as jbuild
from band_tpu.ir import graph as jir
from band_tpu.tflite import schema as jschema
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.executor import ModelExecutor, build_combo
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.errors import ExecutionError, LoweringError
from band_tpu_torch.ir import graph as tir
from band_tpu_torch.tflite import schema as tschema
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter
from tests.gen_torch_seq_models import DATA_DEP, SMALL, SMALL_DIMS, reviews

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL = {"while_loop": (1e-5, 1e-6), "cond": (1e-5, 1e-6),
       "gru_seq_while": (2e-5, 2e-6), "lstm_seq_while": (2e-5, 2e-6),
       DATA_DEP: (1e-5, 1e-6), SMALL[0]: (2e-5, 2e-6),
       SMALL[1]: (2e-5, 2e-6)}


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return tparse(_path(name)), jparse(_path(name))


def request(name, seed, flag=None):
    """A seeded request of ``name``: its inputs in graph order."""
    g = _graphs(name)[0]
    rng = np.random.default_rng(seed)
    out = []
    for t in g.inputs:
        td = g.tensor(t)
        if td.dtype == np.bool_:
            out.append(np.asarray(bool(seed % 2) if flag is None else flag))
        elif td.dtype == np.int32:
            vocab, steps = SMALL_DIMS[:2]
            out.append(reviews(1, seed, vocab, steps, 1)[0])
        else:
            out.append(rng.standard_normal(td.shape).astype(np.float32))
    return out


def tflite(name, xs):
    """TFLite's outputs (graph order), a fresh interpreter."""
    g = _graphs(name)[0]
    it = make_tfl_interpreter(_path(name))
    it.allocate_tensors()
    for t, v in zip(g.inputs, xs):
        it.set_tensor(t, v)
    it.invoke()
    return [np.array(it.get_tensor(t)) for t in g.outputs]


@functools.lru_cache(maxsize=None)
def _port(name):
    g = _graphs(name)[0]
    prog = tbuild(g, range(len(g.ops)))
    return prog, prog.make_fn(), params_from_jax(prog.params)


def port(name, xs):
    """The port's outputs in graph order; a window where xs are stacked."""
    prog, fn, params = _port(name)
    feeds = dict(zip(_graphs(name)[0].inputs, xs))
    outs = fn(params, [torch.from_numpy(np.asarray(feeds[t]))
                       for t in prog.input_ids])
    return [outs[prog.output_ids.index(t)].numpy()
            for t in _graphs(name)[0].outputs]


@functools.lru_cache(maxsize=None)
def _band(name, vmapped=False):
    g = _graphs(name)[1]
    prog = jbuild(g, range(len(g.ops)), exact=True, conv_mode="f32_split")
    fn = prog.make_fn()
    return prog, jax.jit(jax.vmap(fn, in_axes=(None, 0)) if vmapped else fn)


def band(name, xs, vmapped=False):
    prog, fn = _band(name, vmapped)
    feeds = dict(zip(_graphs(name)[1].inputs, xs))
    outs = fn(prog.params, [feeds[t] for t in prog.input_ids])
    return [np.asarray(outs[prog.output_ids.index(t)])
            for t in _graphs(name)[1].outputs]


def close(got, want, name, what):
    rtol, atol = TOL[name]
    got = np.asarray(got).reshape(np.shape(want))
    if np.asarray(want).dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("name", ("while_loop", "gru_seq_while",
                                  "lstm_seq_while", "cond"))
def test_model_matches_tflite_and_band_tpu(name):
    for seed in (0, 1):
        flags = (True, False) if name == "cond" else (None,)
        for flag in flags:
            xs = request(name, seed, flag)
            got = port(name, xs)
            for k, (o, t, b) in enumerate(zip(got, tflite(name, xs),
                                              band(name, xs))):
                close(o, t, name, f"seed {seed} flag {flag} output {k} TFLite")
                close(o, b, name, f"seed {seed} flag {flag} output {k} "
                      "band_tpu")


def _executor(name):
    g = _graphs(name)[0]
    ex = ModelExecutor(0, g, 0, torch.device("cpu"))
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    pos = [ex.output_ids(key).index(t) for t in g.outputs]
    return ex, key, pos


def _ordered(ex, key, name, xs):
    feeds = dict(zip(_graphs(name)[0].inputs, xs))
    return [feeds[t] for t in ex.input_ids(key)]


@pytest.mark.parametrize("name", ("cond", DATA_DEP))
def test_window_equals_solo_and_band_tpu_vmap(name):
    """Windows of 1-8 requests (cond: flags True, False, ... in turn;
    while_data_dep: inputs scaled so the trip counts range 0..16) against
    the requests alone and band_tpu's program vmapped over all 8."""
    ex, key, pos = _executor(name)
    reqs = []
    for s in range(8):
        xs = request(name, 40 + s, flag=bool(s % 2))
        if name == DATA_DEP:
            xs = [xs[0] * np.float32([0.01, 0.3, 1.0, 5.0, 0.05, 2.0, 40.0,
                                      0.002][s])]
        reqs.append(xs)
    stacked = [np.stack([r[k] for r in reqs]) for k in range(len(reqs[0]))]
    vm = band(name, stacked, vmapped=True)
    solo = [[o.numpy() for o in ex.execute(key, _ordered(ex, key, name, r))]
            for r in reqs]
    trips = set()
    for window in (1, 3, 8):
        outs = ex.execute_batched(
            key, [_ordered(ex, key, name, r) for r in reqs[:window]])
        for b in range(window):
            for k, p in enumerate(pos):
                got = outs[b][p].numpy()
                close(got, solo[b][p], name, f"window {window} request {b} "
                      "solo")
                close(got, vm[k][b], name, f"window {window} request {b}")
                close(got, tflite(name, reqs[b])[k], name,
                      f"window {window} request {b} TFLite")
            if name == DATA_DEP:
                trips.update(int(o.reshape(-1)[0]) for o in outs[b]
                             if o.dtype == torch.int32)
    if name == DATA_DEP:
        assert len(trips) >= 5 and 0 in trips, trips


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_imdb_small_both_conversions(seed):
    fused, loops = SMALL
    xs = request(fused, 60 + seed)
    a, b = port(fused, xs), port(loops, xs)
    for name, got in ((fused, a), (loops, b)):
        for k, (o, t, j) in enumerate(zip(got, tflite(name, xs),
                                          band(name, xs))):
            close(o, t, name, f"{name} output {k} TFLite")
            close(o, j, name, f"{name} output {k} band_tpu")
    for k, (o, p) in enumerate(zip(a, b)):
        close(o, p, fused, f"fused against WHILE, output {k}")


def _engine(co_dispatch=1, max_batch=4):
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.FIXED_WORKER)
           .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                     device_ids=(0,), max_batch=max_batch,
                                     co_dispatch=co_dispatch,
                                     dispatch_depth=4))
           .profile_warmups(0).profile_runs(1)
           .build())
    return tb.Engine.create(cfg)


def test_imdb_small_through_the_engine():
    xs = [request(SMALL[0], 80 + s) for s in range(6)]
    eng = _engine()
    try:
        mids = {n: eng.register_model(tb.Model.from_path(_path(n)))
                for n in SMALL}
        assert eng.wait_buckets_ready(timeout=120)
        for name, mid in mids.items():
            want = [port(name, x) for x in xs]
            sync = [eng.request_sync(mid, x) for x in xs[:2]]
            w = eng.workers[0]
            w.pause()
            ids = [eng.request_async(mid, x) for x in xs]
            w.resume()
            burst = [eng.wait(j) for j in ids]
            for i, outs in enumerate(sync + burst):
                r = i if i < 2 else i - 2
                for k, o in enumerate(outs):
                    close(o, want[r][k], name, f"{name} request {i} output "
                          f"{k}")
            assert max(eng.model_record(mid).executors[0].windows) > 1
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# dynamic SLICE
# ----------------------------------------------------------------------
def _slice_graphs(dynamic_size=False):
    """(port, band_tpu) graphs of one SLICE of x [4, 6] float32: begin an
    int32 input and sizes (2, 3) constant, or (dynamic_size) begin (0,)
    constant and the size an input, the slice fed to ABS."""
    def build(ir, schema):
        T = schema.TensorType
        if dynamic_size:
            tensors = [ir.TensorDef(0, "x", (6,), T.FLOAT32),
                       ir.TensorDef(1, "size", (1,), T.INT32),
                       ir.TensorDef(2, "begin", (1,), T.INT32,
                                    data=np.zeros(1, np.int32)),
                       ir.TensorDef(3, "part", (1,), T.FLOAT32),
                       ir.TensorDef(4, "y", (1,), T.FLOAT32)]
            ops = [ir.OpNode(0, "SLICE", [0, 2, 1], [3]),
                   ir.OpNode(1, "ABS", [3], [4])]
            return ir.Graph("s", tensors, ops, [0, 1], [4])
        tensors = [ir.TensorDef(0, "x", (4, 6), T.FLOAT32),
                   ir.TensorDef(1, "begin", (2,), T.INT32),
                   ir.TensorDef(2, "size", (2,), T.INT32,
                                data=np.array([2, 3], np.int32)),
                   ir.TensorDef(3, "y", (2, 3), T.FLOAT32)]
        return ir.Graph("s", tensors, [ir.OpNode(0, "SLICE", [0, 1, 2], [3])],
                        [0, 1], [3])

    return build(tir, tschema), build(jir, jschema)


def test_dynamic_begin_slice_per_request():
    tg, jg = _slice_graphs()
    x = np.arange(3 * 24, dtype=np.float32).reshape(3, 4, 6)
    begins = np.array([[0, 0], [1, 2], [3, 5]], np.int32)  # the last clamped
    prog = tbuild(tg, [0])
    fn, params = prog.make_fn(), params_from_jax(prog.params)
    feeds = {0: x.reshape(12, 6), 1: begins.reshape(6)}
    got = fn(params, [torch.from_numpy(feeds[t]) for t in prog.input_ids])[0]
    jprog = jbuild(jg, [0], exact=True, conv_mode="f32_split")
    jfeeds = {0: x, 1: begins}
    want = jax.vmap(jprog.make_fn(), in_axes=(None, 0))(
        jprog.params, [jfeeds[t] for t in jprog.input_ids])[0]
    np.testing.assert_array_equal(got.numpy().reshape(3, 2, 3),
                                  np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[4:], x[2, 2:4, 3:6])


def test_dynamic_size_slice_outside_the_write_is_refused():
    tg, _ = _slice_graphs(dynamic_size=True)
    prog = tbuild(tg, [0, 1])
    with pytest.raises(LoweringError, match="TensorArray-write pattern"):
        prog.make_fn()(params_from_jax(prog.params),
                       [torch.ones(6), torch.tensor([2], dtype=torch.int32)])


# ----------------------------------------------------------------------
# capture: a program with WHILE or IF is never captured
# ----------------------------------------------------------------------
def test_capturable_flag_and_build_combo_refusal():
    flags = {n: _port(n)[0].capturable
             for n in ("while_loop", "cond", "lstm_seq_while", SMALL[0],
                       SMALL[1], "lstm_seq")}
    assert flags == {"while_loop": False, "cond": False,
                     "lstm_seq_while": False, SMALL[0]: True,
                     SMALL[1]: False, "lstm_seq": True}
    ws, kw, _ = _executor("while_loop")
    fs, kf, _ = _executor(SMALL[0])
    with pytest.raises(ExecutionError, match="reads a value on the host"):
        build_combo([(kw, 1), (kf, 1)], [ws, fs])
    build_combo([(kf, 2)], [fs])


def test_codispatch_worker_serves_a_while_mix_unfused():
    """A co_dispatch worker whose queue mixes a WHILE model with a fused
    LSTM model: no combo is scheduled or built for the mix, its windows
    run one by one (counted by the worker), and every output equals the
    program's own."""
    names = (SMALL[1], SMALL[0])
    xs = [request(SMALL[0], 90 + s) for s in range(4)]
    eng = _engine(co_dispatch=2)
    eng.co_warm_miss_threshold = 1
    try:
        mids = [eng.register_model(tb.Model.from_path(_path(n)))
                for n in names]
        assert eng.wait_buckets_ready(timeout=120)
        w = eng.workers[0]
        w.pause()
        jobs = []
        for r in range(3):
            for name, mid in zip(names, mids):
                ids = eng.request_async_batch([mid] * 2,
                                              [xs[(r + i) % 4]
                                               for i in range(2)])
                jobs += [(j, name, (r + i) % 4) for i, j in enumerate(ids)]
        w.resume()
        st = eng.wait_all([j for j, _, _ in jobs], timeout=120)
        assert all(v == tb.JobStatus.SUCCESS for v in st.values()), st
        for j, name, i in jobs:
            for k, o in enumerate(eng.get_outputs(j)):
                close(o, port(name, xs[i])[k], name, f"job {j}")
        assert w.uncapturable_windows > 0
        assert eng.co_dispatch_count == 0 and not eng._combo_fns
        assert not eng._combo_state
    finally:
        eng.shutdown()


def test_tf32_rule_reaches_into_the_loop_body():
    g = _graphs("lstm_seq_while")[0]
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        # the parent's own FC would name itself first: build the WHILE ops
        loops = [op.index for op in g.ops if op.opname == "WHILE"]
        with pytest.raises(LoweringError, match="FULLY_CONNECTED"):
            tbuild(g, loops, device=torch.device("cuda", 0))
        tbuild(g, loops, device=torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
