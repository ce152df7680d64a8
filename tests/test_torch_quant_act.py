"""The ops of quant_act_int8 in the PyTorch port: SUB, MUL, QUANTIZE,
DEQUANTIZE and the quantized LUT activations LOGISTIC, TANH and ELU (plus
the float32 ELU between a DEQUANTIZE and a QUANTIZE), on the CPU, held
to band_tpu (exact and fast numerics) and to the TFLite interpreter
(BUILTIN_WITHOUT_DEFAULT_DELEGATES), byte for byte (tolerance 0): the
quantization helpers, each op fed TFLite's own inputs, one-op graphs
with two activation operands and uint8 tensors, and the whole model,
per request and as a stacked batch.  The float32 tensors inside the
DEQUANTIZE -> ELU -> QUANTIZE chain have stated ulp tolerances (see
test_each_op_matches_tflite_and_band_tpu); every int8 output has none."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import band_tpu.ir.graph as JG
import band_tpu.tflite.schema as JS
import band_tpu_torch.ir.graph as TG
import band_tpu_torch.tflite.schema as TS
from band_tpu.backend.program import build_program as jbuild
from band_tpu.ops import quant as JQ
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.errors import LoweringError
from band_tpu_torch.ops import quant as TQ
from band_tpu_torch.ops.lowerings import _LUT_TRANSFORMS, LowerCtx
from band_tpu_torch.ops.registry import get_lowering
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODEL = os.path.join(DATA, "quant_act_int8.tflite")
OPS = ["LOGISTIC", "MUL", "TANH", "RESHAPE", "SOFTMAX", "SUB", "DEQUANTIZE",
       "ELU", "QUANTIZE"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(rng, dtype, shape, n):
    info = np.iinfo(dtype)
    return [rng.integers(info.min, info.max + 1, shape).astype(dtype)
            for _ in range(n)]


def _port(graph, ops, ins, exact):
    prog = tbuild(graph, ops, exact=exact)
    outs = prog.make_fn()(params_from_jax(prog.params), [_t(x) for x in ins])
    return prog, [o.numpy() for o in outs]


def _band_tpu(graph, ops, ins, exact):
    prog = jbuild(graph, ops, exact=exact, conv_mode="f32_split")
    outs = jax.jit(prog.make_fn())(prog.params, list(ins))
    return prog, [np.asarray(o) for o in outs]


# --------------------------------------------------------------------------
# quantization helpers
# --------------------------------------------------------------------------

def test_quantize_and_dequantize_match_band_tpu():
    rng = np.random.default_rng(30)
    scale = np.float32(0.0371)
    # exact ties k + 0.5 of the scale, and spread values
    ties = ((np.arange(-300, 300) + 0.5) * scale).astype(np.float32)
    x = np.concatenate([ties, rng.normal(0, 4, 4000).astype(np.float32)])
    for dtype, zp in ((np.int8, -7), (np.uint8, 131)):
        want = np.asarray(JQ.quantize(jnp.asarray(x), scale, zp, dtype))
        got = TQ.quantize(_t(x), float(scale), zp, dtype).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        q = _inputs(rng, dtype, (777,), 1)[0]
        np.testing.assert_array_equal(
            TQ.dequantize(_t(q), float(scale), zp).numpy(),
            np.asarray(JQ.dequantize(jnp.asarray(q), scale, zp)))
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.49, -3.7], np.float32)
    np.testing.assert_array_equal(TQ.round_ties_away(_t(v)).numpy(),
                                  np.asarray(JQ.round_ties_away(v)))


@pytest.mark.parametrize("name", sorted(_LUT_TRANSFORMS))
@pytest.mark.parametrize("dtype,in_zp,out_zp", [(np.int8, 11, -128),
                                                (np.uint8, 140, 0)])
def test_activation_lut_matches_band_tpu(name, dtype, in_zp, out_zp):
    from band_tpu.ops.lowerings import _LUT_TRANSFORMS as J_TRANSFORMS

    args = (0.0561, in_zp, 1.0 / 256, out_zp, dtype)
    table = TQ.activation_lut(_LUT_TRANSFORMS[name], *args)
    want = JQ.activation_lut(J_TRANSFORMS[name], *args)
    assert table.dtype == want.dtype
    np.testing.assert_array_equal(table, want)
    x = np.arange(np.iinfo(dtype).min, np.iinfo(dtype).max + 1).astype(dtype)
    np.testing.assert_array_equal(
        TQ.apply_lut(_t(x), _t(table)).numpy(),
        np.asarray(JQ.apply_lut(jnp.asarray(x), jnp.asarray(want))))


# --------------------------------------------------------------------------
# quant_act_int8, op by op and whole
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opname", OPS)
def test_each_op_matches_tflite_and_band_tpu(opname):
    """Each op fed TFLite's own inputs: the port's exact output equals
    TFLite's tensor and band_tpu's exact op; the fast output equals
    band_tpu's fast op.

    Stated exceptions, for the float32 tensors of DEQUANTIZE and ELU
    only (the int8 output of the QUANTIZE after them is equal to
    TFLite's and band_tpu's, here, in the whole model, and on every input
    byte in the next test):
    - DEQUANTIZE: the port computes (q - zp) * s, one rounding, as
      band_tpu does (byte for byte); TFLite's optimized kernel forms
      q * s - zp * s, two roundings, so its value is off by up to an ulp
      of q * s plus one of zp * s: held to TFLite within 2e-6 absolute
      (|q * s| < 8 here, ulp(8) = 9.5e-7).
    - ELU: the port's expm1 is correctly rounded (float64, rounded once);
      TFLite's float32 expm1 is 1 ulp off on a few percent of the
      elements, XLA's (band_tpu) up to 2 ulp: the ELU output is held to
      TFLite within 1 ulp and to band_tpu within 2."""
    g, jg = tparse(MODEL), jparse(MODEL)
    it = make_tfl_interpreter(MODEL, experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    rng = np.random.default_rng(31)
    ops = [op for op in g.ops if op.opname == opname]
    assert ops
    for x in _inputs(rng, np.int8, (1, 8, 8, 8), 3):
        it.set_tensor(it.get_input_details()[0]["index"], x)
        it.invoke()
        for op in ops:
            prog = tbuild(g, [op.index])
            ins = [it.get_tensor(t).copy() for t in prog.input_ids]
            want = it.get_tensor(op.outputs[0])
            _, (got,) = _port(g, [op.index], ins, exact=True)
            assert got.dtype == want.dtype
            if opname == "DEQUANTIZE":
                np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
            elif opname == "ELU":
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"op {op.index}")
            for exact in (True, False):
                _, (a,) = _port(g, [op.index], ins, exact)
                _, (b,) = _band_tpu(jg, [op.index], ins, exact)
                if opname == "ELU":
                    np.testing.assert_array_max_ulp(a, b, maxulp=2)
                else:
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"op {op.index} exact={exact}")


def test_float_elu_chain_matches_band_tpu_on_every_input_byte():
    """DEQUANTIZE -> ELU -> QUANTIZE takes 256 distinct inputs: every one
    of them gives band_tpu's int8 output.  The ELU between them is the
    correctly rounded float32 (math.expm1, rounded once) on all 256;
    band_tpu's (XLA's float32 expm1) is up to 2 ulp away on 11 of them,
    and no such ulp reaches a QUANTIZE rounding."""
    g, jg = tparse(MODEL), jparse(MODEL)
    chain = [op.index for op in g.ops
             if op.opname in ("DEQUANTIZE", "ELU", "QUANTIZE")]
    x = np.tile(np.arange(-128, 128, dtype=np.int8), 2).reshape(1, 8, 8, 8)
    _, (got,) = _port(g, chain, [x], exact=True)
    _, (want,) = _band_tpu(jg, chain, [x], exact=True)
    np.testing.assert_array_equal(got, want)
    # and the float ELU in between, value for value
    elu = [i for i in chain if g.ops[i].opname == "ELU"]
    f = TQ.dequantize(_t(x), float(g.tensor(g.ops[chain[0]].inputs[0])
                                   .quant.scale[0]),
                      int(g.tensor(g.ops[chain[0]].inputs[0])
                          .quant.zero_point[0])).numpy()
    _, (a,) = _port(g, elu, [f], exact=True)
    _, (b,) = _band_tpu(jg, elu, [f], exact=True)
    exact = np.array([v if v > 0 else np.float32(math.expm1(float(v)))
                      for v in f.ravel()], np.float32).reshape(f.shape)
    np.testing.assert_array_equal(a, exact)
    np.testing.assert_array_max_ulp(a, b, maxulp=2)
    assert (a != b).sum() == 2 * 11  # 11 of the 256 values, tiled twice


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_whole_model_matches_band_tpu_and_tflite(exact):
    g, jg = tparse(MODEL), jparse(MODEL)
    it = make_tfl_interpreter(MODEL)
    it.allocate_tensors()
    rng = np.random.default_rng(32)
    ops = range(len(g.ops))
    for x in _inputs(rng, np.int8, (1, 8, 8, 8), 4):
        tprog, touts = _port(g, ops, [x], exact)
        jprog, jouts = _band_tpu(jg, ops, [x], exact)
        assert tprog.output_ids == jprog.output_ids
        for a, b in zip(touts, jouts):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if exact:
            it.set_tensor(it.get_input_details()[0]["index"], x)
            it.invoke()
            for t, a in zip(tprog.output_ids, touts):
                np.testing.assert_array_equal(a, it.get_tensor(t))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_stacked_batch_of_four_matches_single_requests(exact):
    """A window of 4 stacks on the leading axis: the 0-D constants of
    MUL and SUB broadcast, SOFTMAX takes 4 * 64 rows of 8."""
    g = tparse(MODEL)
    rng = np.random.default_rng(33)
    xs = _inputs(rng, np.int8, (1, 8, 8, 8), 4)
    ex = ModelExecutor(0, g, 0, torch.device("cpu"), exact=exact)
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    for x, outs in zip(xs, ex.execute_batched(key, [[x] for x in xs])):
        for a, b in zip(outs, ex.execute(key, [x])):
            assert a.shape == b.shape
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# one-op graphs: two activation operands, uint8, fused activations
# --------------------------------------------------------------------------

def _binary_graph(G, S, opname, dtype, shapes, scales, zps, act):
    tt = {np.dtype(np.int8): S.TensorType.INT8,
          np.dtype(np.uint8): S.TensorType.UINT8}[np.dtype(dtype)]

    def qp(s, z):
        return G.QuantParams(np.asarray([s], np.float32),
                             np.asarray([z], np.int32), 0)

    tensors = [G.TensorDef(i, f"t{i}", tuple(shapes[i]), tt,
                           qp(scales[i], zps[i])) for i in range(3)]
    op = G.OpNode(0, opname, [0, 1], [2], {"activation": act})
    return G.Graph("one_op", tensors, [op], [0, 1], [2])


@pytest.mark.parametrize("opname", ["SUB", "MUL", "ADD"])
@pytest.mark.parametrize("dtype,act", [(np.int8, "NONE"),
                                       (np.uint8, "RELU"),
                                       (np.int8, "RELU6")])
def test_binary_op_with_two_activations_matches_band_tpu(opname, dtype, act):
    """Both operands are activations, the second broadcast over rows."""
    rng = np.random.default_rng(34)
    zp0 = 5 if dtype == np.int8 else 133
    shapes = [(1, 6, 5, 4), (1, 1, 5, 4), (1, 6, 5, 4)]
    scales, zps = [0.041, 0.017, 0.052], [zp0, zp0 - 9, zp0 + 3]
    graphs = [_binary_graph(G, S, opname, dtype, shapes, scales, zps, act)
              for G, S in ((TG, TS), (JG, JS))]
    ins = [_inputs(rng, dtype, s, 1)[0] for s in shapes[:2]]
    for exact in (True, False):
        _, (a,) = _port(graphs[0], [0], ins, exact)
        _, (b,) = _band_tpu(graphs[1], [0], ins, exact)
        assert a.dtype == b.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"exact={exact}")


@pytest.mark.parametrize("in_dtype,out_dtype", [(np.int8, np.uint8),
                                                (np.uint8, np.int8),
                                                (np.int8, np.int8)])
def test_requantizing_quantize_matches_band_tpu(in_dtype, out_dtype):
    """QUANTIZE from an 8-bit tensor: TFLite's Requantize (ruy MBQM)."""
    rng = np.random.default_rng(35)
    tts = []
    for G, S in ((TG, TS), (JG, JS)):
        tt = {np.dtype(np.int8): S.TensorType.INT8,
              np.dtype(np.uint8): S.TensorType.UINT8}
        tensors = [
            G.TensorDef(0, "x", (2, 9, 7), tt[np.dtype(in_dtype)],
                        G.QuantParams(np.asarray([0.0173], np.float32),
                                      np.asarray([3], np.int32), 0)),
            G.TensorDef(1, "y", (2, 9, 7), tt[np.dtype(out_dtype)],
                        G.QuantParams(np.asarray([0.0411], np.float32),
                                      np.asarray([120 if out_dtype == np.uint8
                                                  else -4], np.int32), 0)),
        ]
        tts.append(G.Graph("q", tensors, [G.OpNode(0, "QUANTIZE", [0], [1],
                                                   {})], [0], [1]))
    x = _inputs(rng, in_dtype, (2, 9, 7), 1)
    _, (a,) = _port(tts[0], [0], x, exact=True)
    _, (b,) = _band_tpu(tts[1], [0], x, exact=True)
    assert a.dtype == b.dtype == np.dtype(out_dtype)
    np.testing.assert_array_equal(a, b)


def test_float_variants_are_refused():
    """A float DEQUANTIZE is not ported: prepare raises.  The float MUL
    and SUB are (band_tpu's float32 product and difference,
    tests/test_torch_float.py holds them op by op), and so are the float
    LOGISTIC and TANH (the Keras LSTMs' gates, band_tpu's jax.nn.sigmoid
    and jnp.tanh: within 1 ulp of them here)."""
    def g(opname, n_in):
        tensors = [TG.TensorDef(i, f"t{i}", (1, 4), TS.TensorType.FLOAT32)
                   for i in range(n_in + 1)]
        return TG.Graph("f", tensors, [TG.OpNode(0, opname,
                                                 list(range(n_in)), [n_in],
                                                 {"activation": "NONE"})],
                        list(range(n_in)), [n_in])

    with pytest.raises(LoweringError):
        tbuild(g("DEQUANTIZE", 1), [0])
    x = np.array([[-9.0, -0.5, 0.0, 3.0]], np.float32)
    for opname, fn in (("LOGISTIC", jax.nn.sigmoid), ("TANH", jnp.tanh)):
        prog = tbuild(g(opname, 1), [0])
        ctx = LowerCtx(prog.graph, {}, prog.meta)
        ctx.set(0, _t(x))
        get_lowering(opname).trace(ctx, prog.graph.ops[0])
        np.testing.assert_allclose(ctx.arr(1).numpy(),
                                   np.asarray(fn(jnp.array(x))),
                                   rtol=1.2e-7, atol=0)
    a = np.array([[-2.0, -0.5, 0.0, 3.0]], np.float32)
    b = np.array([[1.5, -4.0, 2.0, 0.25]], np.float32)
    for opname, want in (("MUL", a * b), ("SUB", a - b)):
        prog = tbuild(g(opname, 2), [0])
        ctx = LowerCtx(prog.graph, {}, prog.meta)
        ctx.set(0, _t(a))
        ctx.set(1, _t(b))
        get_lowering(opname).trace(ctx, prog.graph.ops[0])
        np.testing.assert_array_equal(ctx.arr(2).numpy(), want)
    # the float ELU is ported
    prog = tbuild(g("ELU", 1), [0])
    ctx = LowerCtx(prog.graph, {}, prog.meta)
    ctx.set(0, _t(np.array([[-2.0, -0.5, 0.0, 3.0]], np.float32)))
    get_lowering("ELU").trace(ctx, prog.graph.ops[0])
    np.testing.assert_array_equal(
        ctx.arr(1).numpy(),
        np.asarray(jax.nn.elu(jnp.array([[-2.0, -0.5, 0.0, 3.0]],
                                        jnp.float32))))
