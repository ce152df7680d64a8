"""The fused UNIDIRECTIONAL_SEQUENCE_LSTM in the port, on the CPU.

- lstm_seq and bilstm_seq (tests/data, Keras LSTMs fused by the
  converter) as whole programs of the port, against TFLite and band_tpu
  on the same seeded input: rtol 2e-5, atol 2e-6 (tests/test_lstm.py's
  tolerance);
- lstm_seq_int8 (the full-int8 8x8_16 kernel, band_tpu's float
  simulation): within 1 LSB of TFLite (tests/test_lstm.py:82's bound) on
  four seeded inputs; the count of codes that differ from band_tpu is
  printed;
- one-op LSTM graphs built on both packages' IR, each feature alone
  (CIFG, peepholes, projection with its clip, per-gate layer norm, the
  cell clip, time-major) and all together, through both packages'
  lowerings: rtol 2e-5, atol 2e-6;
- windows of 1, 3 and 8 requests through the executor equal to the same
  requests alone (float: rtol 2e-5, atol 2e-6; int8: within 1 LSB, the
  differing codes printed);
- the TF32 rule: an LSTM program for a card is refused while cuBLAS's
  TF32 flag is on.

TFLite's LSTM keeps its h and c variable tensors between invoke() calls,
so every TFLite output here comes from a fresh interpreter.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from band_tpu.backend.program import build_program as jbuild
from band_tpu.ir import graph as jir
from band_tpu.tflite import schema as jschema
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.errors import LoweringError
from band_tpu_torch.ir import graph as tir
from band_tpu_torch.tflite import schema as tschema
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RTOL, ATOL = 2e-5, 2e-6
FLOAT_MODELS = ("lstm_seq", "bilstm_seq")
INT8 = "lstm_seq_int8"


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return tparse(_path(name)), jparse(_path(name))


def seeded_input(name, seed):
    td = _graphs(name)[0].tensor(_graphs(name)[0].inputs[0])
    rng = np.random.default_rng(seed)
    if td.dtype == np.int8:
        return rng.integers(-128, 128, td.shape).astype(np.int8)
    return rng.standard_normal(td.shape).astype(np.float32)


def tflite_output(name, x):
    """TFLite's first output, from a fresh interpreter."""
    g = _graphs(name)[0]
    it = make_tfl_interpreter(_path(name))
    it.allocate_tensors()
    it.set_tensor(g.inputs[0], x)
    it.invoke()
    return np.array(it.get_tensor(g.outputs[0]))


@functools.lru_cache(maxsize=None)
def _port(name):
    g = _graphs(name)[0]
    prog = tbuild(g, range(len(g.ops)))
    return prog, prog.make_fn(), params_from_jax(prog.params)


@functools.lru_cache(maxsize=None)
def _band(name):
    g = _graphs(name)[1]
    prog = jbuild(g, range(len(g.ops)), exact=True, conv_mode="f32_split")
    return prog, jax.jit(prog.make_fn())


def port_output(name, x):
    prog, fn, params = _port(name)
    outs = fn(params, [torch.from_numpy(x)])
    return outs[prog.output_ids.index(_graphs(name)[0].outputs[0])].numpy()


def band_output(name, x):
    prog, fn = _band(name)
    outs = fn(prog.params, [x])
    return np.asarray(outs[prog.output_ids.index(_graphs(name)[1].outputs[0])])


@pytest.mark.parametrize("name", FLOAT_MODELS)
def test_float_lstm_matches_tflite_and_band_tpu(name):
    hist = _graphs(name)[0].op_histogram()
    assert hist["UNIDIRECTIONAL_SEQUENCE_LSTM"] >= 2
    for seed in (0, 1):
        x = seeded_input(name, seed)
        got = port_output(name, x)
        np.testing.assert_allclose(got, tflite_output(name, x), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got, band_output(name, x), rtol=RTOL,
                                   atol=ATOL)


def test_int8_lstm_within_one_lsb_of_tflite():
    differ = 0
    for seed in range(4):
        x = seeded_input(INT8, seed)
        got = port_output(INT8, x)
        want = tflite_output(INT8, x)
        assert got.dtype == want.dtype == np.int8
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, (seed, d.max())
        differ += int((got != band_output(INT8, x)).sum())
    print(f"{INT8}: codes that differ from band_tpu over 4 requests: "
          f"{differ}")


# ----------------------------------------------------------------------
# one-op LSTM graphs on both packages' IR
# ----------------------------------------------------------------------
def lstm_graphs(cifg=False, peephole=False, proj=False, ln=False,
                cell_clip=0.0, proj_clip=0.0, time_major=False, seed=0,
                batch=2, steps=5, n_in=3, n_cell=4):
    """One UNIDIRECTIONAL_SEQUENCE_LSTM as (port graph, band_tpu graph),
    the same seeded weights in both: input 0 the sequence, 1-4 the input
    weights (i absent with CIFG), 5-8 the recurrent ones, 9-11 the
    peepholes, 12-15 the biases, 16-17 the projection, 18-19 the state
    variables, 20-23 the layer-norm coefficients."""
    rng = np.random.default_rng(seed)
    n_out = 3 if proj else n_cell
    xshape = (steps, batch, n_in) if time_major else (batch, steps, n_in)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    consts = {}
    for k, g in enumerate("ifco"):
        if not (cifg and g == "i"):
            consts[1 + k] = w(n_cell, n_in)
            consts[5 + k] = w(n_cell, n_out)
            consts[12 + k] = w(n_cell)
            if ln:
                consts[20 + k] = (1.0 + w(n_cell)).astype(np.float32)
    if peephole:
        for k, g in enumerate("ifo"):
            if not (cifg and g == "i"):
                consts[9 + k] = w(n_cell)
    if proj:
        consts[16] = w(n_out, n_cell)
        consts[17] = w(n_out)
    consts[18] = np.zeros((batch, n_out), np.float32)
    consts[19] = np.zeros((batch, n_cell), np.float32)
    out_shape = xshape[:2] + (n_out,)
    options = {"activation": "TANH", "cell_clip": cell_clip,
               "proj_clip": proj_clip, "time_major": time_major,
               "asymmetric_quantize_inputs": False}

    def build(ir, schema):
        f32 = schema.TensorType.FLOAT32
        tensors = [ir.TensorDef(0, "x", xshape, f32)]
        inputs = [0] + [-1] * 23
        for pos, data in sorted(consts.items()):
            inputs[pos] = len(tensors)
            tensors.append(ir.TensorDef(len(tensors), f"c{pos}", data.shape,
                                        f32, data=data))
        out = len(tensors)
        tensors.append(ir.TensorDef(out, "y", out_shape, f32))
        op = ir.OpNode(0, "UNIDIRECTIONAL_SEQUENCE_LSTM", inputs, [out],
                       dict(options))
        return ir.Graph("lstm", tensors, [op], [0], [out])

    return build(tir, tschema), build(jir, jschema)


LSTM_CASES = {
    "plain": {},
    "cifg": dict(cifg=True),
    "peephole": dict(peephole=True),
    "projection_clip": dict(proj=True, proj_clip=0.3),
    "layer_norm": dict(ln=True),
    "cell_clip": dict(cell_clip=0.4),
    "time_major": dict(time_major=True),
    "all": dict(cifg=True, peephole=True, proj=True, ln=True, cell_clip=0.5,
                proj_clip=0.4, time_major=True),
}


@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_one_op_lstm_matches_band_tpu(case):
    tg, jg = lstm_graphs(**LSTM_CASES[case])
    x = np.random.default_rng(9).standard_normal(
        tg.tensor(0).shape).astype(np.float32) * 2.0
    tprog = tbuild(tg, [0])
    got = tprog.make_fn()(params_from_jax(tprog.params),
                          [torch.from_numpy(x)])[0].numpy()
    jprog = jbuild(jg, [0], exact=True, conv_mode="f32_split")
    want = np.asarray(jax.jit(jprog.make_fn())(jprog.params, [x])[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # every feature moves the output away from the plain LSTM's; the
    # time-major one is the plain LSTM on the transposed sequence
    if case == "plain":
        return
    plain, _ = lstm_graphs()
    pprog = tbuild(plain, [0])
    tm = LSTM_CASES[case].get("time_major", False)
    ref = pprog.make_fn()(params_from_jax(pprog.params), [torch.from_numpy(
        np.ascontiguousarray(x.swapaxes(0, 1)) if tm else x)])[0].numpy()
    if tm:
        ref = ref.swapaxes(0, 1)
    if case == "time_major":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        assert ref.shape != got.shape or not np.allclose(ref, got)


def _runtime_operands(g, op):
    """A copy of ``g`` whose LSTM ``op`` reads every weight, bias,
    peephole, projection and layer-norm operand at run time, and those
    operands' constant values."""
    import copy

    g = copy.deepcopy(g)
    op = g.ops[op.index]
    values = {}
    for i, tid in enumerate(op.inputs):
        td = g.tensor(tid) if tid >= 0 else None
        if i in (0, 18, 19) or td is None or td.data is None \
                or td.data.size == 0:
            continue
        values[tid] = np.ascontiguousarray(td.data)
        td.data = None
    return g, values


@pytest.mark.parametrize("case", ["all", "plain", INT8])
def test_runtime_lstm_operands(case):
    """Runtime LSTM operands (every weight, bias, peephole, projection and
    layer-norm coefficient a value at run time, as in a loop body): the
    port's one-op program equals its program on the same constants
    exactly (the same float32 stacking at run time), and band_tpu's on
    the same runtime values within rtol 2e-5, atol 2e-6."""
    if case == INT8:
        tg, jg = _graphs(INT8)
        op = next(o for o in tg.ops
                  if o.opname == "UNIDIRECTIONAL_SEQUENCE_LSTM")
        x = np.random.default_rng(4).integers(
            -128, 128, tg.tensor(op.inputs[0]).shape).astype(np.int8)
    else:
        tg, jg = lstm_graphs(**LSTM_CASES[case])
        op = tg.ops[0]
        x = np.random.default_rng(4).standard_normal(
            tg.tensor(0).shape).astype(np.float32)
    const = tbuild(tg, [op.index])
    want = const.make_fn()(params_from_jax(const.params),
                           [torch.from_numpy(x)])[0].numpy()
    rg, values = _runtime_operands(tg, op)
    jrg, _ = _runtime_operands(jg, op)
    assert len(values) >= 8
    feeds = {**values, op.inputs[0]: x}
    prog = tbuild(rg, [op.index])
    assert prog.meta[f"op{op.index}/runtime"]
    got = prog.make_fn()(params_from_jax(prog.params), [
        torch.from_numpy(feeds[t]) for t in prog.input_ids])[0].numpy()
    np.testing.assert_array_equal(got, want)
    jprog = jbuild(jrg, [op.index], exact=True, conv_mode="f32_split")
    ref = np.asarray(jax.jit(jprog.make_fn())(
        jprog.params, [feeds[t] for t in jprog.input_ids])[0])
    if case == INT8:
        assert np.abs(got.astype(np.int32) - ref).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ("bilstm_seq", INT8))
def test_window_equals_solo(name):
    g = _graphs(name)[0]
    ex = ModelExecutor(0, g, 0, torch.device("cpu"))
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    xs = [seeded_input(name, 20 + s) for s in range(8)]
    solo = [ex.execute(key, [x])[0].numpy() for x in xs]
    differ = 0
    for window in (1, 3, 8):
        outs = ex.execute_batched(key, [[x] for x in xs[:window]])
        for b in range(window):
            got = outs[b][0].numpy()
            if got.dtype == np.int8:
                d = np.abs(got.astype(np.int32) - solo[b].astype(np.int32))
                assert d.max() <= 1, (window, b)
                differ += int((d > 0).sum())
            else:
                np.testing.assert_allclose(got, solo[b], rtol=RTOL, atol=ATOL)
    print(f"{name}: windows against solo, differing int8 codes {differ}")


def test_lstm_takes_the_tf32_rule():
    g = _graphs("lstm_seq")[0]
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(LoweringError, match=r"matmul\.allow_tf32"):
            tbuild(g, range(len(g.ops)), device=torch.device("cuda", 0))
        tbuild(g, range(len(g.ops)), device=torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
