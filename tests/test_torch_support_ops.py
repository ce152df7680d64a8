"""The support op set, op by op and whole: every op of support_ops,
support_ops2 and centernet_small_int8 that the port registered for it
runs as a one-op program of the port and of band_tpu (conv_mode=
"f32_split"), both fed the TFLite interpreter's own input tensors to it
(experimental_preserve_all_tensors=True, builtin kernels), and is
compared with band_tpu's output and with TFLite's.  Both support models
are also served whole through the engine on a CPU worker.

Inputs: per model two seeded requests (integers in [-40, 40) and
standard-normal floats, as tests/test_support_ops.py feeds them; int8
inputs over the whole range).

Tolerances:
- bool, integer and int8 outputs: 0, against TFLite and against
  band_tpu (whose JAX runs without 64-bit types: its int32 stands for an
  int64 output, ARG_MIN's, and is compared as that);
- float outputs: within rtol 2e-5, atol 2e-5 of both (the tolerance
  tests/test_support_ops.py holds band_tpu to TFLite with): pow (LRN),
  atan2, the FFT and the 3-D conv's summation order differ between
  libraries by a few ulps; the other float ops print how many values
  differ at all.
"""

import copy
import functools
import os

import jax
import numpy as np
import pytest
import torch

import band_tpu_torch as tb
from band_tpu.backend.program import build_program as jbuild
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ops import lowerings as L
from band_tpu_torch.ops.registry import REGISTRY
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SUPPORT = ("support_ops", "support_ops2")
MODELS = SUPPORT + ("centernet_small_int8",)
SEEDS = (0, 1)
RTOL = ATOL = 2e-5
# the op types this slice registered (the models' other ops are older)
NEW_OPS = {
    "CAST", "MINIMUM", "MAXIMUM", "LOGICAL_NOT", "SELECT", "SELECT_V2",
    "REDUCE_MIN", "REDUCE_PROD", "REDUCE_ANY", "REDUCE_ALL", "ARG_MIN",
    "FLOOR_DIV", "FLOOR_MOD", "REVERSE_V2", "GATHER_ND", "SPACE_TO_BATCH_ND",
    "BATCH_TO_SPACE_ND", "ONE_HOT", "CUMSUM", "TOPK_V2", "TILE",
    "LOCAL_RESPONSE_NORMALIZATION", "SCATTER_ND", "SEGMENT_SUM",
    "UNSORTED_SEGMENT_SUM", "UNSORTED_SEGMENT_MAX", "UNSORTED_SEGMENT_MIN",
    "UNSORTED_SEGMENT_PROD", "REVERSE_SEQUENCE", "MATRIX_DIAG",
    "MATRIX_SET_DIAG", "ATAN2", "SIGN", "BITWISE_XOR", "RIGHT_SHIFT",
    "CONV_3D", "RFFT2D", "COMPLEX_ABS", "REAL", "IMAG", "GREATER",
    "GREATER_EQUAL", "LESS", "LESS_EQUAL", "EQUAL", "NOT_EQUAL",
    "LOGICAL_AND", "LOGICAL_OR"}


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return tparse(_path(name)), jparse(_path(name))


def request_inputs(name, seed):
    """One seeded request of ``name``: its input arrays in graph order."""
    g = _graphs(name)[0]
    rng = np.random.default_rng(seed)
    out = []
    for t in g.inputs:
        td = g.tensor(t)
        if td.dtype.kind == "f":
            out.append(rng.standard_normal(td.shape).astype(td.dtype))
        elif td.quant is not None:
            info = np.iinfo(td.dtype)
            out.append(rng.integers(info.min, info.max + 1, td.shape)
                       .astype(td.dtype))
        else:
            out.append(rng.integers(-40, 40, td.shape).astype(td.dtype))
    return out


@functools.lru_cache(maxsize=None)
def _tensors(name, seed):
    """Every tensor of one TFLite run on a seeded request."""
    it = make_tfl_interpreter(_path(name),
                              experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    g = _graphs(name)[0]
    by_index = {d["index"]: d for d in it.get_input_details()}
    for t, x in zip(g.inputs, request_inputs(name, seed)):
        it.set_tensor(by_index[t]["index"], x)
    it.invoke()
    out = {}
    for t in range(len(g.tensors)):
        if g.tensor(t).is_constant:
            continue
        try:
            out[t] = np.array(it.get_tensor(t))
        except ValueError:
            pass
    return out


def _cases():
    return [pytest.param(name, op.index,
                         id=f"{name}-{op.index}-{op.opname}")
            for name in MODELS for op in _graphs(name)[0].ops
            if op.opname in NEW_OPS]


def _run_port(g, ops, feeds):
    prog = tbuild(g, ops)
    outs = prog.make_fn()(params_from_jax(prog.params),
                          [torch.from_numpy(feeds[t]) for t in prog.input_ids])
    return prog, [o.numpy() for o in outs]


def _run_band_tpu(g, ops, feeds):
    prog = jbuild(g, ops, exact=True, conv_mode="f32_split")
    outs = jax.jit(prog.make_fn())(prog.params,
                                   [feeds[t] for t in prog.input_ids])
    return prog, [np.asarray(o) for o in outs]


def held(got, want, what, counts):
    """got against want: 0 for bool and integer outputs, RTOL/ATOL for
    floats; counts[what] = how many values differ."""
    if got.dtype == np.int64 and want.dtype == np.int32:
        want = want.astype(np.int64)  # JAX without x64
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, got.dtype, want.shape, want.dtype)
    counts[what] = int((got != want).sum())
    if got.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name,index", _cases())
def test_op_matches_band_tpu_and_tflite(name, index):
    tg, jg = _graphs(name)
    op = tg.ops[index]
    tprog = tbuild(tg, [index])
    tfn, tparams = tprog.make_fn(), params_from_jax(tprog.params)
    jprog = jbuild(jg, [index], exact=True, conv_mode="f32_split")
    jfn = jax.jit(jprog.make_fn())
    assert tprog.output_ids == jprog.output_ids
    counts = {}
    for seed in SEEDS:
        feeds = _tensors(name, seed)
        touts = [o.numpy() for o in tfn(tparams, [
            torch.from_numpy(feeds[t]) for t in tprog.input_ids])]
        jouts = [np.asarray(o) for o in jfn(
            jprog.params, [feeds[t] for t in jprog.input_ids])]
        for t, got, want in zip(tprog.output_ids, touts, jouts):
            held(got, feeds[t], f"seed {seed} TFLite tensor {t}", counts)
            held(got, want, f"seed {seed} band_tpu tensor {t}", counts)
    print(f"{name} op {index} {op.opname}: differing values {counts}")


def test_every_op_of_the_models_is_registered():
    """The registry covers every op of the support models and both
    CenterNet files, and each new op is in one of them."""
    seen = set()
    for name in MODELS + ("centernet_mnv2_fpn_int8",):
        ops = {op.opname for op in tparse(_path(name)).ops}
        assert ops <= set(REGISTRY), (name, ops - set(REGISTRY))
        seen |= ops
    # MAXIMUM and LOGICAL_NOT are held below on renamed ops
    assert NEW_OPS - seen == {"MAXIMUM", "LOGICAL_NOT"}


@pytest.mark.parametrize("opname,source", [("MAXIMUM", "MINIMUM"),
                                           ("LOGICAL_NOT", "CAST")])
def test_renamed_op_matches_band_tpu(opname, source):
    """Ops no model emits (the converter folds them), run on another op's
    inputs with the op renamed in both packages' graphs: MAXIMUM on
    support_ops' MINIMUM, LOGICAL_NOT on a bool tensor (support_ops'
    GREATER output fed through its CAST op, renamed)."""
    tg, jg = (copy.deepcopy(g) for g in _graphs("support_ops"))
    op = next(o for o in tg.ops if o.opname == source)
    feeds = dict(_tensors("support_ops", 0))
    if opname == "LOGICAL_NOT":
        gt = next(o for o in tg.ops if o.opname == "GREATER")
        for g in (tg, jg):
            g.ops[op.index].inputs[0] = gt.outputs[0]
            g.tensor(op.outputs[0]).ttype = g.tensor(gt.outputs[0]).ttype
            g.tensor(op.outputs[0]).shape = g.tensor(gt.outputs[0]).shape
    tg.ops[op.index].opname = jg.ops[op.index].opname = opname
    (got,) = _run_port(tg, [op.index], feeds)[1]
    (want,) = _run_band_tpu(jg, [op.index], feeds)[1]
    held(got, want, opname, {})


def test_topk_ties_take_the_lower_index_first():
    """An all-tied row and a row of few distinct values: TOPK_V2's indices
    in index order among equal values, as TFLite and lax.top_k give
    them (int8, float32 with -0.0 and +0.0, int32)."""
    tg, jg = _graphs("centernet_small_int8")
    op = next(o for o in tg.ops if o.opname == "TOPK_V2")
    n = tg.tensor(op.inputs[0]).shape[-1]
    k = int(np.asarray(tg.tensor(op.inputs[1]).data).reshape(()))
    rng = np.random.default_rng(3)
    rows = {"tied": np.full((1, n), 5, np.int8),
            "few": rng.integers(-2, 3, (1, n)).astype(np.int8)}
    for what, row in rows.items():
        (vals, idx) = _run_port(tg, [op.index], {op.inputs[0]: row})[1]
        (jvals, jidx) = _run_band_tpu(jg, [op.index], {op.inputs[0]: row})[1]
        order = np.lexsort((np.arange(n), -row[0].astype(np.int64)))[:k]
        np.testing.assert_array_equal(idx[0], order, err_msg=what)
        np.testing.assert_array_equal(idx, jidx, err_msg=what)
        np.testing.assert_array_equal(vals, jvals, err_msg=what)
    assert list(_run_port(tg, [op.index], {op.inputs[0]: rows["tied"]})[1][1]
                [0]) == list(range(k))
    ctx = L.LowerCtx(tg, {}, {}, batch=2)
    for x in (torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0, 1.0]] * 2),
              torch.tensor([[3, -7, 3, 3, -7, 9]] * 2, dtype=torch.int32)):
        key = L._order_key(x)
        assert torch.equal(torch.argsort(key, stable=True, descending=True),
                           torch.argsort(x, stable=True, descending=True))
    del ctx


def _engine(max_batch=4):
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.FIXED_WORKER)
           .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                     device_ids=(0,), max_batch=max_batch))
           .profile_warmups(1).profile_runs(1)
           .build())
    return tb.Engine.create(cfg)


def tflite_outputs(name, xs):
    """TFLite's outputs (graph order) for each request of ``xs``."""
    it = make_tfl_interpreter(_path(name))
    it.allocate_tensors()
    g = _graphs(name)[0]
    outs = []
    for x in xs:
        for t, v in zip(g.inputs, x):
            it.set_tensor(t, v)
        it.invoke()
        outs.append([np.array(it.get_tensor(t)) for t in g.outputs])
    return outs


@pytest.mark.parametrize("name", SUPPORT)
def test_model_through_the_engine(name):
    """The whole model on a CPU worker, request_sync and a burst of
    request_async, against TFLite (within the tolerances above) and
    band_tpu's whole program."""
    xs = [request_inputs(name, s) for s in SEEDS]
    want = tflite_outputs(name, xs)
    jg = _graphs(name)[1]
    jprog = jbuild(jg, range(len(jg.ops)), exact=True, conv_mode="f32_split")
    jfn = jax.jit(jprog.make_fn())
    pos = [jprog.output_ids.index(t) for t in jg.outputs]
    eng = _engine()
    try:
        mid = eng.register_model(tb.Model.from_path(_path(name)))
        assert eng.wait_buckets_ready(timeout=120)
        sync = [eng.request_sync(mid, x) for x in xs]
        ids = [eng.request_async(mid, xs[i % 2]) for i in range(4)]
        burst = [eng.wait(j) for j in ids]
    finally:
        eng.shutdown()
    counts = {}
    for i, outs in enumerate(sync + burst):
        r = i % 2
        feeds = dict(zip(jg.inputs, xs[r]))
        band = jfn(jprog.params, [feeds[t] for t in jprog.input_ids])
        for j, o in enumerate(outs):
            held(np.asarray(o), want[r][j], f"request {i} output {j} TFLite",
                 counts)
            held(np.asarray(o), np.asarray(band[pos[j]]),
                 f"request {i} output {j} band_tpu", counts)
    print(f"{name}: differing values {counts}")


def test_conv3d_takes_the_tf32_rule():
    """CONV_3D is a float32 contraction: a card's program with it is
    refused while cuDNN's TF32 flag is on (a LoweringError naming the
    flag); off, or for the CPU, it builds."""
    from band_tpu_torch.errors import LoweringError

    g = _graphs("support_ops2")[0]
    op = next(o for o in g.ops if o.opname == "CONV_3D")
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(LoweringError, match=r"cudnn\.allow_tf32"):
            tbuild(g, [op.index], device=torch.device("cuda", 0))
        tbuild(g, [op.index], device=torch.device("cpu"))
        torch.backends.cudnn.allow_tf32 = False
        tbuild(g, [op.index], device=torch.device("cuda", 0))
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_quantized_comparison_follows_tflite(shift):
    """Fault C8 (ROADMAP): on int8 inputs TFLite compares each input's
    integer rescale ((x - zp) << 8, MBQM by its scale), band_tpu the
    dequantized floats.  compare_int8's EQUAL and GREATER (scales below
    1/256, differing in the fifth digit) on every code against itself
    plus ``shift``: the port equals TFLite on every value (tolerance 0);
    band_tpu differs from TFLite.  Fast numerics keep band_tpu's form:
    equal to band_tpu on every value."""
    name = "compare_int8"
    tg, jg = _graphs(name)
    a = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    b = np.clip(a.astype(np.int64) + shift, -128, 127).astype(np.int8)
    it = make_tfl_interpreter(_path(name))
    it.allocate_tensors()
    feeds = dict(zip(tg.inputs, (a, b)))
    for t, v in feeds.items():
        it.set_tensor(t, v)
    it.invoke()
    ops = list(range(len(tg.ops)))
    tprog, touts = _run_port(tg, ops, feeds)
    jprog, jouts = _run_band_tpu(jg, ops, feeds)
    differ = 0
    for t, got, band in zip(tprog.output_ids, touts, jouts):
        want = np.array(it.get_tensor(t))
        held(got, want, f"shift {shift} tensor {t}", {})
        differ += int((band != want).sum())
    assert differ > 0
    fprog = tbuild(tg, ops, exact=False)
    fouts = fprog.make_fn()(params_from_jax(fprog.params),
                            [torch.from_numpy(feeds[t])
                             for t in fprog.input_ids])
    for got, band in zip(fouts, jouts):
        held(got.numpy(), band, f"shift {shift} fast", {})
    print(f"shift {shift}: band_tpu differs from TFLite on {differ} values")
