"""Float32, fp16 and dynamic-range (hybrid) models in the PyTorch port,
on the CPU, against band_tpu and the TFLite interpreter.

- Op by op: every op of fp16_cnn, dynrange and the float toy (float32
  and dynamic range; tests/gen_torch_float_models.py) runs as a one-op
  program of the port, fed the TFLite interpreter's own input tensors,
  and of band_tpu (conv_mode="f32_split"); the convs and FCs also with
  band_tpu's prepared parameters (``params_from_jax``) in place of the
  port's own; a few ops also with an edited
  option (SOFTMAX's beta, the hybrid FC's symmetric inputs and fused
  activations).  Float outputs: rtol 1e-5, atol 1e-6, band_tpu's own
  tolerance (tests/test_model_families.py:95).  Hybrid ops: the int8
  codes, zero points and scales of the quantized input equal band_tpu's,
  and the outputs are within rtol 1e-5, atol 1e-6 (a 1x1 conv adds in
  int32 here and over float32 residuals in band_tpu, which rounds past
  2^24: about an ulp).
- ``qmatmul_hybrid_plain`` against band_tpu's ``_hybrid_fc_matmul``:
  symmetric and asymmetric rows, a zero row, K of 8, 1280 and 8192.
- The slice: fp16_cnn and dynrange through the port's engine on a CPU
  worker against band_tpu's engine and TFLite (the tolerances of
  tests/test_model_families.py:95 and :113), the all-zero input of
  :116-130 included; a float model registers, warms its buckets, serves
  sync and async, the same under numerics("fast"), and under the tool.
- The full-width MobileNetV2 fp16 and dynamic-range models, one request
  each, against tests/data/torch_float_goldens.npz under the card's gate
  (top-1 equal to TFLite's, largest deviation at most max(2 x band_tpu's,
  1e-4 x max|golden|)).
- Stacked windows: a window of 4 equals the requests served alone
  (|diff| <= 1e-6 x max|out| float, 1e-5 hybrid), also beside a
  neighbour scaled by 1000 or all zero.
- Refusals: runtime FC weights; the TF32 rule for a card's program.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import band_tpu as jb
import band_tpu_torch as tb
from band_tpu.backend.program import build_program as jbuild
from band_tpu.ir.graph import OpNode as JOpNode
from band_tpu.ops import lowerings as JL
from band_tpu.ops import quant as JQ
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.errors import LoweringError
from band_tpu_torch.ops import lowerings as L
from band_tpu_torch.ops import quant as Q
from band_tpu_torch.ops.kernels import qmatmul as QM
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from band_tpu_torch.tools import benchmark as tbench
from tests.conftest import make_tfl_interpreter
from tests.gen_torch_float_models import FLOAT_GOLDENS_PATH, float_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODELS = ("fp16_cnn", "dynrange", "float_toy", "float_toy_dynrange")
SEEDS = (0, 1)
RTOL, ATOL = 1e-5, 1e-6
# ops whose float and hybrid prepares keep band_tpu's parameter keys
SHARED_KEYS = ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED")


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return tparse(_path(name)), jparse(_path(name))


@functools.lru_cache(maxsize=None)
def _tensors(name, seed):
    """Every tensor of one TFLite run on a seeded uniform [-1, 1] input."""
    it = make_tfl_interpreter(_path(name),
                              experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    ind = it.get_input_details()[0]
    it.set_tensor(ind["index"], np.random.default_rng(seed).uniform(
        -1.0, 1.0, ind["shape"]).astype(np.float32))
    it.invoke()
    g = _graphs(name)[0]
    out = {}
    for t in range(len(g.tensors)):
        if g.tensor(t).is_constant:
            continue
        try:
            out[t] = np.array(it.get_tensor(t))
        except ValueError:
            pass
    return out


def _hybrid(g, op):
    if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
        return False
    w = g.tensor(op.inputs[1])
    return w.dtype == np.int8 and g.tensor(op.inputs[0]).dtype.kind == "f"


def _run_band_tpu(g, ops, feeds):
    prog = jbuild(g, ops, exact=True, conv_mode="f32_split")
    outs = jax.jit(prog.make_fn())(prog.params,
                                   [feeds[t] for t in prog.input_ids])
    return prog, [np.asarray(o) for o in outs]


def _run_port(g, ops, feeds, params=None):
    prog = tbuild(g, ops)
    p = params_from_jax(prog.params if params is None else params)
    outs = prog.make_fn()(p, [torch.from_numpy(feeds[t])
                              for t in prog.input_ids])
    return prog, [o.numpy() for o in outs]


def _close(got, want, rel):
    """|got - want| <= rel * max|want| everywhere."""
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def _band_tpu_sym_rows(x):
    """band_tpu's symmetric row quantizer (band_tpu/ops/lowerings.py:
    984-991), as it runs there."""
    amax = jnp.abs(x).max(axis=1, keepdims=True)
    scale = jnp.where(amax == 0.0, 1.0, amax / 127.0)
    q = jnp.clip(JQ.round_ties_away(x / scale), -127.0, 127.0)
    return jnp.where(amax == 0.0, 0.0, q), scale


def _codes_equal(x, asym):
    """The port's quantized input (codes, zero points, scales) equals
    band_tpu's as band_tpu runs it (jitted: XLA turns its divisions by 255
    and 127 into multiplies by their reciprocals), bit for bit."""
    if asym:
        want = jax.jit(JL._asym_quant_rows)(jnp.asarray(x))
        got = Q.asym_quant_rows(torch.from_numpy(x))
    else:
        want = jax.jit(_band_tpu_sym_rows)(jnp.asarray(x))
        got = Q.sym_quant_rows(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _check_op(tg, jg, index, seeds=SEEDS):
    op = tg.ops[index]
    for seed in seeds:
        feeds = _tensors(tg.name, seed)
        jprog, jouts = _run_band_tpu(jg, [index], feeds)
        tprog, touts = _run_port(tg, [index], feeds)
        runs = [touts]
        if op.opname in SHARED_KEYS:
            # band_tpu's prepared parameters, under the keys they share
            runs.append(_run_port(tg, [index], feeds, jprog.params)[1])
        assert tprog.output_ids == jprog.output_ids
        for outs in runs:
            for got, want in zip(outs, jouts):
                assert got.shape == want.shape and got.dtype == want.dtype
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        if _hybrid(tg, op):
            x = feeds[op.inputs[0]]
            if op.opname == "FULLY_CONNECTED":
                x = x.reshape(-1, x.shape[-1])
            _codes_equal(x, op.opname != "FULLY_CONNECTED" or op.options.get(
                "asymmetric_quantize_inputs", False))


def _cases():
    out = []
    for name in MODELS:
        g = tparse(_path(name))
        g.name = name
        for op in g.ops:
            out.append(pytest.param(name, op.index,
                                    id=f"{name}-{op.index}-{op.opname}"))
    return out


@functools.lru_cache(maxsize=None)
def _named(name):
    tg, jg = _graphs(name)
    tg.name = jg.name = name
    return tg, jg


@pytest.mark.parametrize("name,index", _cases())
def test_op_matches_band_tpu(name, index):
    tg, jg = _named(name)
    _check_op(tg, jg, index)


def _edited(name, opname, **options):
    tg, jg = (copy.deepcopy(g) for g in _named(name))
    index = next(op.index for op in tg.ops if op.opname == opname)
    for g in (tg, jg):
        g.ops[index].options.update(options)
    return tg, jg, index


@pytest.mark.parametrize("name,opname,options", [
    ("float_toy", "SOFTMAX", {"beta": 0.5}),
    ("float_toy_dynrange", "FULLY_CONNECTED",
     {"asymmetric_quantize_inputs": False}),
    ("float_toy_dynrange", "FULLY_CONNECTED", {"activation": "RELU6"}),
    ("float_toy_dynrange", "FULLY_CONNECTED", {"activation": "NONE"}),
    ("float_toy_dynrange", "FULLY_CONNECTED", {"activation": "TANH"}),
    ("float_toy", "AVERAGE_POOL_2D", {"activation": "RELU6"}),
    ("float_toy", "ADD", {"activation": "RELU"}),
], ids=["softmax-beta", "fc-symmetric", "fc-relu6", "fc-none", "fc-tanh",
        "avgpool-relu6", "add-relu"])
def test_edited_op_matches_band_tpu(name, opname, options):
    tg, jg, index = _edited(name, opname, **options)
    _check_op(tg, jg, index)


def test_toys_cover_the_float_and_hybrid_op_set():
    """The op kinds the port now takes in float, and every hybrid route
    (the 1x1 GEMM, a residual conv, a residual depthwise conv, the FC)."""
    kinds = set()
    for name in MODELS:
        kinds |= set(tparse(_path(name)).op_histogram())
    assert {"CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED", "ADD", "SUB",
            "MUL", "MAX_POOL_2D", "AVERAGE_POOL_2D", "MEAN", "SOFTMAX",
            "RELU", "RELU6", "CONCATENATION", "PAD", "RESIZE_BILINEAR",
            "RESHAPE"} <= kinds
    g = tparse(_path("float_toy_dynrange"))
    routes = {(op.opname, L._gemm_conv(g, op)
               if op.opname == "CONV_2D" else False)
              for op in g.ops if _hybrid(g, op)}
    assert routes == {("CONV_2D", True), ("CONV_2D", False),
                      ("DEPTHWISE_CONV_2D", False),
                      ("FULLY_CONNECTED", False)}


# --------------------------------------------------------------------------
# qmatmul_hybrid's plain version against band_tpu's hybrid FC
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 1280, 8192])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_hybrid_plain_matches_band_tpu(k, asym):
    rng = np.random.default_rng(k + asym)
    m, n = 5, 24
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
    x[2] = 0.0  # a degenerate row: q = 0, zp = 0, scale = 1
    x[3] = np.abs(x[3])  # rmin clamps to 0
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    rowsum = w.astype(np.int64).sum(axis=0).astype(np.int32)
    op = JOpNode(index=0, opname="FULLY_CONNECTED", inputs=[], outputs=[],
                 options={"asymmetric_quantize_inputs": asym})
    ctx = JL.LowerCtx(None, {"op0/w_q": w, "op0/w_scale": w_scale,
                             "op0/w_rowsum": rowsum}, {},
                      conv_mode="f32_split")
    want = np.asarray(jax.jit(lambda v: JL._hybrid_fc_matmul(ctx, op, v))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x)
    if asym:
        q, zp, scale = Q.asym_quant_rows(xt)
        zp = zp.reshape(-1)
    else:
        (q, scale), zp = Q.sym_quant_rows(xt), None
    got = QM.qmatmul_hybrid(q.to(torch.int8), torch.from_numpy(w),
                            torch.from_numpy(w_scale),
                            torch.from_numpy(rowsum), zp, scale.reshape(-1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any()


def test_hybrid_plain_groups_rows_and_fuses_bias_and_activation():
    """rows > 1 (a 1x1 conv's H*W pixels per request) is the per-row form
    with zp and scale repeated; bias and RELU6 follow the product."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-128, 128, (12, 40)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (40, 16)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(0.01, 0.02, 16).astype(np.float32))
    rs = b.to(torch.int32).sum(dim=0).to(torch.int32)
    zp = torch.tensor([-3.0, 7.0, 0.0])
    scale = torch.tensor([0.5, 0.25, 1.0])
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    got = QM.qmatmul_hybrid(a, b, ws, rs, zp, scale, bias, rows=4,
                            activation="RELU6")
    want = QM.qmatmul_hybrid(a, b, ws, rs, zp.repeat_interleave(4),
                             scale.repeat_interleave(4), bias,
                             activation="RELU6")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    acc = (a.double() @ b.double()).float()
    v = ((acc - zp.repeat_interleave(4)[:, None] * rs.float())
         * (scale.repeat_interleave(4)[:, None] * ws) + bias).clamp(0, 6)
    np.testing.assert_array_equal(got.numpy(), v.numpy())


def test_hybrid_wrapper_has_no_other_device():
    """A tensor on neither the CPU nor a card has no kernel and no plain
    fallback: the wrapper raises."""
    a = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    b = torch.zeros((8, 4), dtype=torch.int8, device="meta")
    f = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        QM.qmatmul_hybrid(a, b, f, None, None, torch.zeros(2, device="meta"))


# --------------------------------------------------------------------------
# The slice through the engine
# --------------------------------------------------------------------------

def _engine(pkg, numerics="exact", max_batch=4):
    cfg = (pkg.RuntimeConfigBuilder()
           .add_scheduler(pkg.SchedulerType.FIXED_WORKER)
           .add_worker(pkg.WorkerSpec(device=pkg.DeviceFlag.CPU,
                                      device_ids=(0,), max_batch=max_batch))
           .profile_warmups(1).profile_runs(1)
           .numerics(numerics)
           .build())
    return pkg.Engine.create(cfg)


def _serve(pkg, name, xs, numerics="exact"):
    eng = _engine(pkg, numerics)
    try:
        mid = eng.register_model(pkg.Model.from_path(_path(name)))
        assert eng.wait_buckets_ready(timeout=120)
        sync = [eng.request_sync(mid, [x])[0] for x in xs]
        ids = [eng.request_async(mid, [xs[i % len(xs)]]) for i in range(8)]
        burst = [eng.wait(j)[0] for j in ids]
        warm = None
        if pkg is tb:
            warm = eng.model_record(mid).executors[0].max_warm_bucket(
                next(iter(eng.model_record(mid).executors[0]._programs)))
        return sync, burst, warm
    finally:
        eng.shutdown()


def _tflite(name, xs):
    it = make_tfl_interpreter(_path(name))
    it.allocate_tensors()
    ind, outd = it.get_input_details()[0], it.get_output_details()[0]
    outs = []
    for x in xs:
        it.set_tensor(ind["index"], x)
        it.invoke()
        outs.append(it.get_tensor(outd["index"]).copy())
    return outs


@pytest.mark.parametrize("name,rtol,atol,rel", [("fp16_cnn", 1e-5, 1e-6, 1e-6),
                                                ("dynrange", 1e-4, 1e-5, 1e-5)])
def test_slice_matches_band_tpu_and_tflite(name, rtol, atol, rel):
    """Sync (b1) outputs against band_tpu's engine (rtol 1e-5, atol 1e-6),
    TFLite (the model's tolerance) and numerics("fast") (equal); burst
    outputs, served in windows whose sizes vary with timing, against the
    same request's sync output within the stacked-window tolerance."""
    g = tparse(_path(name))
    xs = list(float_inputs(5, g.tensor(g.inputs[0]).shape, 3))
    xs.append(np.zeros_like(xs[0]))  # the degenerate rows
    tsync, tburst, warm = _serve(tb, name, xs)
    jsync, _, _ = _serve(jb, name, xs)
    fsync, fburst, _ = _serve(tb, name, xs, numerics="fast")
    assert warm == 4  # the buckets up to max_batch ran
    want = _tflite(name, xs)
    for i, out in enumerate(tsync):
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, jsync[i], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out, want[i], rtol=rtol, atol=atol)
        np.testing.assert_array_equal(fsync[i], out)
    for i, (out, fout) in enumerate(zip(tburst, fburst)):
        _close(out, tsync[i % len(xs)], rel)
        _close(fout, tsync[i % len(xs)], rel)


def test_float_model_runs_under_the_tool():
    d = {
        "models": [{"graph": _path("dynrange"), "period_ms": 10,
                    "batch_size": 2, "slo_scale": 100.0},
                   {"graph": _path("fp16_cnn"), "period_ms": 10,
                    "batch_size": 1}],
        "schedulers": ["fixed_worker"],
        "execution_mode": "stream",
        "workers": [{"device": "cpu", "device_ids": [0]}],
        "running_time_ms": 300,
        "profile_online": True,
        "profile_warmup_runs": 1,
        "profile_num_runs": 1,
    }
    bench = tbench.Benchmark(tbench.BenchmarkConfig.from_dict(d))
    try:
        report = bench.run()
    finally:
        bench.shutdown()
    assert report["model_0"]["processed"] > 0
    assert report["model_1"]["processed"] > 0
    assert report["total"]["canceled"] == 0


# --------------------------------------------------------------------------
# The full-width models against their goldens
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _executor(name):
    g = tb.Model.from_path(_path(name)).graph
    ex = ModelExecutor(0, g, 0, torch.device("cpu"))
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    return ex, key, g


def gate(out, golden, band_dev):
    """The card's gate: top-1 equal to TFLite's and the largest absolute
    deviation at most max(2 x band_tpu's, 1e-4 x max|golden|)."""
    dev = float(np.abs(out.astype(np.float64) - golden).max())
    limit = max(2.0 * float(band_dev), 1e-4 * float(np.abs(golden).max()))
    return int(out.argmax()) == int(golden.argmax()) and dev <= limit, dev


@pytest.mark.parametrize("name", ["mobilenet_v2_fp16",
                                  "mobilenet_v2_dynrange"])
def test_full_width_model_meets_the_gate(name):
    z = np.load(FLOAT_GOLDENS_PATH)
    ex, key, g = _executor(name)
    xs = float_inputs(int(z[f"{name}/seed"]), g.tensor(g.inputs[0]).shape)
    (out,) = ex.execute(key, [xs[0]])
    ok, dev = gate(out.numpy(), z[f"{name}/tflite"][0], z[f"{name}/dev"][0])
    assert out.shape == (1, 1000) and ok, (name, dev)


def test_goldens_hold_every_model():
    z = np.load(FLOAT_GOLDENS_PATH)
    for name in ("mobilenet_v2_fp16", "mobilenet_v2_dynrange", "fp16_cnn",
                 "dynrange"):
        assert z[f"{name}/tflite"].shape[0] == 8
        assert z[f"{name}/dev"].shape == (8,)


# --------------------------------------------------------------------------
# Stacked windows: each request quantized by its own range
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,rel", [("float_toy", 1e-6),
                                      ("fp16_cnn", 1e-6),
                                      ("float_toy_dynrange", 1e-5),
                                      ("dynrange", 1e-5),
                                      ("mobilenet_v2_dynrange", 1e-5)])
def test_stacked_window_equals_single_requests(name, rel):
    ex, key, g = _executor(name)
    n = 2 if name.startswith("mobilenet") else 4
    xs = list(float_inputs(9, g.tensor(g.inputs[0]).shape, n))
    alone = [ex.execute(key, [x])[0].numpy() for x in xs]
    window = ex.execute_batched(key, [[x] for x in xs])
    for (got,), want in zip(window, alone):
        _close(got.numpy(), want, rel)


@pytest.mark.parametrize("name", ["float_toy_dynrange", "dynrange"])
@pytest.mark.parametrize("neighbour", ["x1000", "zero"])
def test_hybrid_request_is_isolated_from_its_neighbour(name, neighbour):
    """Per-request quantization: a request's output does not move when
    its window holds a request 1000 times larger or all zero."""
    ex, key, g = _executor(name)
    x, y = float_inputs(11, g.tensor(g.inputs[0]).shape, 2)
    other = y * 1000.0 if neighbour == "x1000" else np.zeros_like(y)
    (alone,) = ex.execute(key, [x])
    (got,), (other_out,) = ex.execute_batched(key, [[x], [other]])
    _close(got.numpy(), alone.numpy(), 1e-5)
    if neighbour == "zero":
        (zero_alone,) = ex.execute(key, [other])
        _close(other_out.numpy(), zero_alone.numpy(), 1e-5)


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_runtime_fc_weights_are_refused():
    """Runtime int8 weights (a control-flow subgraph's input) are refused:
    no model makes them, and B1 needs prepared weights.  Runtime float
    weights run (tests/test_torch_control_flow.py holds them in loop
    bodies): here the same as the constant weights, exactly."""
    g8 = copy.deepcopy(tparse(_path("fc_int8")))
    op = next(op for op in g8.ops if op.opname == "FULLY_CONNECTED")
    g8.tensor(op.inputs[1]).data = None
    with pytest.raises(LoweringError, match="runtime int8 weights"):
        tbuild(g8, [op.index])
    g = tparse(_path("float_toy"))
    op = next(op for op in g.ops if op.opname == "FULLY_CONNECTED")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        g.tensor(op.inputs[0]).shape).astype(np.float32))
    prog = tbuild(g, [op.index])
    (want,) = prog.make_fn()(params_from_jax(prog.params), [x])
    gr = copy.deepcopy(g)
    w = gr.tensor(op.inputs[1])
    w_data, w.data = w.data, None
    rprog = tbuild(gr, [op.index])
    feeds = {op.inputs[0]: x, op.inputs[1]: torch.from_numpy(w_data)}
    (got,) = rprog.make_fn()(params_from_jax(rprog.params),
                             [feeds[t] for t in rprog.input_ids])
    assert torch.equal(got, want)


@pytest.fixture
def tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


@pytest.mark.parametrize("name,opname,flag", [
    ("float_toy", "CONV_2D", L.TF32_CONV),
    ("float_toy", "DEPTHWISE_CONV_2D", L.TF32_CONV),
    ("float_toy_dynrange", "DEPTHWISE_CONV_2D", L.TF32_CONV),
    ("float_toy", "FULLY_CONNECTED", L.TF32_MATMUL),
    ("attention_int8", "BATCH_MATMUL", L.TF32_MATMUL),
])
def test_tf32_rule_refuses_a_cards_program(tf32_flags, name, opname, flag):
    """A program for a card with a float32 contraction is refused while
    the TF32 flag that would change it is on, with a LoweringError naming
    the flag; off, or for the CPU, it builds.  The hybrid GEMMs take no
    flag."""
    g = tparse(_path(name))
    op = next(op for op in g.ops if op.opname == opname and (
        name != "float_toy_dynrange" or _hybrid(g, op)))
    cuda = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = flag == L.TF32_CONV
    torch.backends.cuda.matmul.allow_tf32 = flag == L.TF32_MATMUL
    with pytest.raises(LoweringError, match=flag.replace(".", r"\.")):
        tbuild(g, [op.index], device=cuda)
    tbuild(g, [op.index], device=torch.device("cpu"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tbuild(g, [op.index], device=cuda)


def test_tf32_rule_passes_the_hybrid_gemms(tf32_flags):
    g = tparse(_path("float_toy_dynrange"))
    gemms = [op.index for op in g.ops if _hybrid(g, op) and (
        op.opname == "FULLY_CONNECTED" or L._gemm_conv(g, op))]
    assert len(gemms) == 3
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tbuild(g, gemms, device=torch.device("cuda", 0))


# --------------------------------------------------------------------------
# The structural ops of the int8 decoder models, on float tensors
# --------------------------------------------------------------------------

STRUCTURAL = {"RESHAPE", "CONCATENATION", "PAD", "PADV2", "MIRROR_PAD",
              "SPLIT", "SPLIT_V", "SLICE", "STRIDED_SLICE", "PACK",
              "TRANSPOSE", "DEPTH_TO_SPACE", "SPACE_TO_DEPTH",
              "RESIZE_NEAREST_NEIGHBOR", "RESIZE_BILINEAR", "RELU", "RELU6",
              "MAX_POOL_2D", "AVERAGE_POOL_2D", "MEAN"}


def _structural_cases():
    out = []
    for name in ("cnn_ops_int8", "tconv_int8", "attention_int8"):
        g = tparse(_path(name))
        for op in g.ops:
            x = g.tensor(op.inputs[0] if op.opname not in ("SPLIT",)
                         else op.inputs[1])
            if (op.opname in STRUCTURAL and not x.is_constant
                    and x.dtype.kind in "iu" and x.quant is not None):
                out.append(pytest.param(name, op.index,
                                        id=f"{name}-{op.index}-{op.opname}"))
    return out


def _as_float(g, op):
    """The op's data tensors made float32 and unquantized (its constant
    operands unchanged): the float variant of an int8 model's op."""
    from band_tpu_torch.tflite.schema import TensorType

    for tid in list(op.inputs) + list(op.outputs):
        td = g.tensor(tid) if tid >= 0 else None
        if td is not None and not td.is_constant and td.dtype.kind in "iu" \
                and td.quant is not None:
            td.ttype = type(td.ttype)(TensorType.FLOAT32.value)
            td.quant = None


@pytest.mark.parametrize("name,index", _structural_cases())
def test_structural_op_on_float_tensors_matches_band_tpu(name, index):
    """Every structural op (and pool, MEAN, RELU) PR 8 ported, with its
    data tensors float32: the port's one-op program equals band_tpu's (the
    byte moves exactly; the pools, MEAN and RESIZE_BILINEAR within rtol
    1e-5, atol 1e-6)."""
    tg, jg = (copy.deepcopy(g) for g in _graphs(name))
    _as_float(tg, tg.ops[index])
    _as_float(jg, jg.ops[index])
    rng = np.random.default_rng(index)
    feeds = {tid: rng.uniform(-3.0, 3.0, tg.tensor(tid).shape).astype(
        np.float32) for tid in tg.ops[index].inputs
        if tid >= 0 and not tg.tensor(tid).is_constant}
    jprog, jouts = _run_band_tpu(jg, [index], feeds)
    tprog, touts = _run_port(tg, [index], feeds)
    assert tprog.output_ids == jprog.output_ids
    for got, want in zip(touts, jouts):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
