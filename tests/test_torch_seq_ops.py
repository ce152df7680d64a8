"""The last op types of band_tpu's registry in the port, and the whole
registry, on the CPU.

- GATHER (the Embedding's constant table at per-request ids, a
  per-request table at constant indices along axis 1, per-request tables
  at per-request indices with negative and out-of-range ones, int8 codes)
  and the 15 op types no tests/data model holds (the converter folds or
  rewrites them): ADD_N, ARG_MAX, BROADCAST_TO, DIV, EXPAND_DIMS, FILL,
  L2_NORMALIZATION, LOG_SOFTMAX, POW, RANK, REDUCE_MAX, SQUEEZE, SUM,
  UNPACK, ZEROS_LIKE, each as a one-op graph built on both packages' IR
  from the same seeded numpy inputs: one request against band_tpu's
  program, and a window of three against band_tpu's program under
  jax.vmap and against each request alone.  Tolerance: 0 for integer,
  bool and int8 outputs; floats rtol 2e-5, atol 2e-6 (POW, LOG_SOFTMAX,
  L2_NORMALIZATION and SUM round differently in XLA and PyTorch by an
  ulp or two; the printed counts say how many values differ at all);
- a request-free output (RANK's) through the executor in a window of
  three: every request gets the one value;
- the port's REGISTRY holds every op type of band_tpu's (119);
- every tests/data/*.tflite model (and the two full-width IMDB models of
  tests/data/imdb_bilstm.tar.xz) builds in the port, and every
  tests/data/*.tflite is served through the public API on a CPU worker
  (one request of zeros), its outputs of the graph's shapes and types.
"""

import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch

import band_tpu_torch as tb
from band_tpu.backend.program import build_program as jbuild
from band_tpu.ir import graph as jir
from band_tpu.ops.registry import REGISTRY as JREGISTRY
from band_tpu.tflite import schema as jschema
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ir import graph as tir
from band_tpu_torch.ops.registry import REGISTRY
from band_tpu_torch.tflite import schema as tschema
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.gen_torch_seq_models import extract

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RTOL, ATOL = 2e-5, 2e-6
WINDOW = 3
TYPES = {np.float32: "FLOAT32", np.int32: "INT32", np.int8: "INT8",
         np.bool_: "BOOL", np.int64: "INT64"}


def graphs(opname, inputs, outputs, options=None):
    """(port graph, band_tpu graph) of one op.  ``inputs``: (shape, dtype,
    constant data or None) per input; ``outputs``: (shape, dtype)."""
    def build(ir, schema):
        tensors, ins = [], []
        for shape, dt, data in inputs:
            ins.append(len(tensors))
            tensors.append(ir.TensorDef(
                len(tensors), f"t{len(tensors)}", tuple(shape),
                getattr(schema.TensorType, TYPES[np.dtype(dt).type]),
                data=None if data is None else np.asarray(data, dt)))
        outs = []
        for shape, dt in outputs:
            outs.append(len(tensors))
            tensors.append(ir.TensorDef(
                len(tensors), f"t{len(tensors)}", tuple(shape),
                getattr(schema.TensorType, TYPES[np.dtype(dt).type])))
        op = ir.OpNode(0, opname, ins, outs, dict(options or {}))
        runtime = [t for t, (_, _, d) in zip(ins, inputs) if d is None]
        return ir.Graph(opname.lower(), tensors, [op], runtime, outs)

    return build(tir, tschema), build(jir, jschema)


R = np.random.default_rng(2024)
F32, I32, I8 = np.float32, np.int32, np.int8


def _f(*shape):
    return R.standard_normal(shape).astype(F32)


# name -> (opname, inputs, outputs, options); runtime inputs are drawn
# per request by ``draw``
CASES = {
    "ADD_N": ("ADD_N", [((2, 3), F32, None), ((2, 3), F32, None),
                        ((2, 3), F32, _f(2, 3))], [((2, 3), F32)], {}),
    "ARG_MAX_axis1": ("ARG_MAX", [((2, 5), I32, None), ((1,), I32, [1])],
                      [((2,), I32)], {}),
    "ARG_MAX_axis0": ("ARG_MAX", [((4, 3), F32, None), ((), I32, 0)],
                      [((3,), I32)], {}),
    "BROADCAST_TO": ("BROADCAST_TO", [((1, 3), F32, None),
                                      ((3,), I32, [2, 2, 3])],
                     [((2, 2, 3), F32)], {}),
    "DIV": ("DIV", [((2, 3), F32, None), ((3,), F32, [0.5, -2.0, 3.0])],
            [((2, 3), F32)], {"activation": "RELU"}),
    "EXPAND_DIMS": ("EXPAND_DIMS", [((2, 3), F32, None), ((), I32, 1)],
                    [((2, 1, 3), F32)], {}),
    "FILL": ("FILL", [((2,), I32, [2, 3]), ((), F32, None)],
             [((2, 3), F32)], {}),
    "L2_NORMALIZATION": ("L2_NORMALIZATION", [((2, 4), F32, None)],
                         [((2, 4), F32)], {"activation": "NONE"}),
    "LOG_SOFTMAX_rank1": ("LOG_SOFTMAX", [((5,), F32, None)],
                          [((5,), F32)], {}),
    "LOG_SOFTMAX": ("LOG_SOFTMAX", [((2, 4), F32, None)], [((2, 4), F32)],
                    {}),
    "POW": ("POW", [((2, 3), F32, None), ((3,), F32, [0.5, 2.0, -1.5])],
            [((2, 3), F32)], {}),
    "RANK": ("RANK", [((2, 3, 4), F32, None)], [((), I32)], {}),
    "REDUCE_MAX": ("REDUCE_MAX", [((2, 3, 4), F32, None),
                                  ((2,), I32, [0, 2])], [((3,), F32)],
                   {"keep_dims": False}),
    "REDUCE_MAX_int8": ("REDUCE_MAX", [((2, 3, 4), I8, None),
                                       ((1,), I32, [-1])],
                        [((2, 3, 1), I8)], {"keep_dims": True}),
    "SQUEEZE": ("SQUEEZE", [((1, 3, 1), F32, None)], [((3,), F32)],
                {"squeeze_dims": [0, 2]}),
    "SUM": ("SUM", [((2, 3, 4), F32, None), ((1,), I32, [1])],
            [((2, 1, 4), F32)], {"keep_dims": True}),
    "UNPACK": ("UNPACK", [((3, 2), F32, None)],
               [((2,), F32), ((2,), F32), ((2,), F32)],
               {"num": 3, "axis": 0}),
    "UNPACK_axis1": ("UNPACK", [((3, 2), I32, None)],
                     [((3,), I32), ((3,), I32)], {"num": 2, "axis": 1}),
    "ZEROS_LIKE": ("ZEROS_LIKE", [((2, 3), I32, None)], [((2, 3), I32)],
                   {}),
    "GATHER_embedding": ("GATHER", [((10, 4), F32, _f(10, 4)),
                                    ((2, 3), I32, None)],
                         [((2, 3, 4), F32)], {"axis": 0}),
    "GATHER_table_axis1": ("GATHER", [((4, 5, 3), F32, None),
                                      ((3,), I32, [4, -1, 0])],
                           [((4, 3, 3), F32)], {"axis": 1}),
    "GATHER_out_of_range": ("GATHER", [((6, 2), F32, None),
                                       ((4,), I32, None)],
                            [((4, 2), F32)], {"axis": 0}),
    "GATHER_int8": ("GATHER", [((8, 2), I8, R.integers(-128, 128, (8, 2))),
                               ((1, 4), I32, None)], [((1, 4, 2), I8)],
                    {"axis": 0}),
}


def draw(case, seed):
    """One request's runtime inputs of ``case``."""
    opname, inputs, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    out = []
    for k, (shape, dt, data) in enumerate(inputs):
        if data is not None:
            continue
        if opname == "GATHER":
            # [-7, 7): negative and out of range for the 6-row table
            lo, hi = ((-7, 7) if case == "GATHER_out_of_range"
                      else (0, inputs[0][0][0]))
            out.append(rng.integers(lo, hi, shape).astype(dt))
        elif dt == I32:
            out.append(rng.integers(-3, 3, shape).astype(dt))
        elif dt == I8:
            out.append(rng.integers(-128, 128, shape).astype(dt))
        elif opname == "POW":
            out.append(rng.uniform(0.1, 3.0, shape).astype(dt))
        else:
            out.append(rng.standard_normal(shape).astype(dt))
    return out


def held(got, want, what, counts):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, got.dtype, want.shape, want.dtype)
    counts[what] = int((got != want).sum() - (np.isnan(got) & np.isnan(
        want)).sum()) if got.dtype.kind == "f" else int((got != want).sum())
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@functools.lru_cache(maxsize=None)
def _programs(case):
    opname, inputs, outputs, options = CASES[case]
    tg, jg = graphs(opname, inputs, outputs, options)
    tprog = tbuild(tg, [0])
    jprog = jbuild(jg, [0], exact=True, conv_mode="f32_split")
    assert tprog.input_ids == jprog.input_ids
    return tprog, jprog


def _stacked(xs):
    """A window's inputs: each request's [d0, ...] stacked (scalars [B])."""
    return [torch.from_numpy(np.concatenate([np.atleast_1d(x) for x in col]))
            for col in zip(*xs)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_band_tpu_alone_and_in_a_window(case):
    tprog, jprog = _programs(case)
    fn, params = tprog.make_fn(), params_from_jax(tprog.params)
    jfn = jax.jit(jprog.make_fn())
    vfn = jax.jit(jax.vmap(jprog.make_fn(), in_axes=(None, 0)))
    xs = [draw(case, 10 + b) for b in range(WINDOW)]
    counts = {}
    solo = []
    for b, x in enumerate(xs):
        got = [o.numpy() for o in fn(params, [torch.from_numpy(v)
                                              for v in x])]
        want = [np.asarray(o) for o in jfn(jprog.params, x)]
        for k, (g, w) in enumerate(zip(got, want)):
            held(g, w, f"request {b} output {k}", counts)
        solo.append(got)
    win = [o.numpy() for o in fn(params, _stacked(xs))]
    vm = [np.asarray(o) for o in vfn(jprog.params, [np.stack(c) for c in
                                                    zip(*xs)])]
    for k, (o, v, free) in enumerate(zip(win, vm, tprog.output_free)):
        for b in range(WINDOW):
            # a request-free output (RANK's) is one value for the window
            part = o if free else np.split(o, WINDOW)[b].reshape(v[b].shape)
            held(part, v[b], f"window request {b} output {k} vmap", counts)
            held(part, solo[b][k].reshape(v[b].shape),
                 f"window request {b} output {k} solo", counts)
    print(f"{case}: differing values {counts}")


def test_request_free_output_is_every_requests_in_a_window():
    """RANK's output carries no request axis: through the executor, each
    request of a window of 3 gets the one value."""
    from band_tpu_torch.backend.executor import ModelExecutor

    tg, _ = graphs(*CASES["RANK"][:3])
    ex = ModelExecutor(0, tg, 0, torch.device("cpu"))
    key = ex.prepare_subgraph([0], [0])
    assert ex.program(key).output_free == (True,)
    outs = ex.execute_batched(key, [draw("RANK", 10 + b)
                                    for b in range(WINDOW)])
    assert [int(o[0]) for o in outs] == [3] * WINDOW


def test_gather_out_of_range_reads_the_fill():
    """jnp.take's fill: NaN for a float table past [-n, n)."""
    tprog, _ = _programs("GATHER_out_of_range")
    x = [np.arange(12, dtype=F32).reshape(6, 2),
         np.array([-1, 6, -7, 2], I32)]
    (out,) = tprog.make_fn()(params_from_jax(tprog.params),
                             [torch.from_numpy(v) for v in x])
    out = out.numpy()
    np.testing.assert_array_equal(out[0], [10, 11])
    assert np.isnan(out[1]).all() and np.isnan(out[2]).all()
    np.testing.assert_array_equal(out[3], [4, 5])


def test_registry_holds_band_tpu_s():
    assert set(JREGISTRY) <= set(REGISTRY)
    assert len(REGISTRY) >= 119


def _models():
    return sorted(glob.glob(os.path.join(DATA, "*.tflite")))


def test_every_model_builds():
    """Every subgraph's ops registered, and the whole primary subgraph
    prepared (a host worker's program: SSD's post-process is a host op);
    the full-width IMDB models too."""
    paths = _models() + list(extract(os.path.join(
        os.path.dirname(DATA), "..", "band_tpu_torch", "_build",
        "data")).values())
    for path in paths:
        g = tparse(path)
        prog = tbuild(g, range(len(g.ops)), host=True)
        assert prog.output_ids, path


def test_every_model_serves_through_the_engine():
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.FIXED_WORKER)
           .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                     device_ids=(0,), max_batch=1))
           .profile_warmups(0).profile_runs(1)
           .build())
    eng = tb.Engine.create(cfg)
    try:
        for path in _models():
            g = tparse(path)
            mid = eng.register_model(tb.Model.from_path(path))
            xs = [np.zeros([max(s, 1) for s in g.tensor(t).shape] if
                           g.tensor(t).shape else (),
                           g.tensor(t).dtype) for t in g.inputs]
            outs = eng.request_sync(mid, xs)
            assert len(outs) == len(g.outputs), path
            for o, t in zip(outs, g.outputs):
                td = g.tensor(t)
                assert np.asarray(o).dtype == td.dtype, (path, t)
                assert np.asarray(o).size == max(int(np.prod(td.shape)), 1), (
                    path, t)
            eng.unregister_model(mid)
    finally:
        eng.shutdown()
