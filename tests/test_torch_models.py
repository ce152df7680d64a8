"""Whole models through the PyTorch port's executor on the CPU, held to
band_tpu's executor (conv_mode="f32_split") and to the TFLite
interpreter (BUILTIN_WITHOUT_DEFAULT_DELEGATES), byte for byte
(tolerance 0), per request and as a stacked batch.

band_tpu's MEAN rounds differently from TFLite 2.21 on a few outputs
(band_tpu_torch/ops/lowerings.py _prepare_mean); the port follows
TFLite.  So the port is held to band_tpu on the programs below and above
each MEAN, and to TFLite on every op and on the whole model."""

import os

import jax
import numpy as np
import pytest
import torch

from band_tpu.backend.program import build_program as jbuild
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ops.lowerings import LowerCtx
from band_tpu_torch.ops.registry import get_lowering
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SMALL = ["effnetlite_int8", "resnetish_int8", "fc_int8"]


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


def _goldens(name):
    z = np.load(GOLDENS_PATH)
    g = tparse(_path(name))
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                       len(want))
    return xs, want, z[f"{name}/logits"], int(z[f"{name}/logits_tid"])


def _run_port(graph, ops, inputs):
    prog = tbuild(graph, ops)
    outs = prog.make_fn()(params_from_jax(prog.params),
                          [torch.from_numpy(np.ascontiguousarray(x))
                           for x in inputs])
    return prog, [o.numpy() for o in outs]


def _run_band_tpu(graph, ops, inputs):
    prog = jbuild(graph, ops, exact=True, conv_mode="f32_split")
    outs = jax.jit(prog.make_fn())(prog.params, list(inputs))
    return prog, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("name", SMALL)
def test_executor_matches_band_tpu_and_tflite(name):
    xs, want, _, _ = _goldens(name)
    tg, jg = tparse(_path(name)), jparse(_path(name))
    n = len(tg.ops)
    means = [op.index for op in tg.ops if op.opname == "MEAN"]
    cuts = [0] + [c for m in means for c in (m, m + 1)] + [n]
    segments = [list(range(a, b)) for a, b in zip(cuts[:-1], cuts[1:])
                if b > a and tg.ops[a].opname != "MEAN"]
    for i, x in enumerate(xs[:4]):
        # whole model: TFLite's output
        _, (out,) = _run_port(tg, range(n), [x])
        np.testing.assert_array_equal(out, want[i])
        # each MEAN-free segment, fed the port's own activations: band_tpu
        prog_all = tbuild(tg, range(n))
        ctx = LowerCtx(tg, params_from_jax(prog_all.params), prog_all.meta)
        ctx.set(tg.inputs[0], torch.from_numpy(x))
        for op in tg.ops:
            get_lowering(op.opname).trace(ctx, op)
        for seg in segments:
            tprog = tbuild(tg, seg)
            ins = [ctx.arr(t).numpy() for t in tprog.input_ids]
            _, touts = _run_port(tg, seg, ins)
            jprog, jouts = _run_band_tpu(jg, seg, ins)
            assert tprog.output_ids == jprog.output_ids
            for a, b in zip(touts, jouts):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", SMALL)
def test_stacked_batch_of_four_matches_single_requests(name):
    xs, want, _, _ = _goldens(name)
    g = tparse(_path(name))
    ex = ModelExecutor(0, g, 0, torch.device("cpu"))
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    batch = ex.execute_batched(key, [[x] for x in xs[:4]])
    # a window of 3 is padded to the bucket of 4 with its first request
    three = ex.execute_batched(key, [[x] for x in xs[4:7]])
    assert ex.windows[4] == 2
    for i, outs in enumerate(batch + three):
        np.testing.assert_array_equal(outs[0].numpy(), want[i])
        single = ex.execute(key, [xs[i]])
        np.testing.assert_array_equal(single[0].numpy(), want[i])


@pytest.mark.parametrize("name", SMALL)
def test_prepared_weights_match_band_tpu(name):
    """The shared prepared keys equal band_tpu's, and band_tpu's prepared
    weights carried across (params_from_jax) give the port's outputs."""
    tg, jg = tparse(_path(name)), jparse(_path(name))
    ops = range(len(tg.ops))
    tprog = tbuild(tg, ops)
    jprog = jbuild(jg, ops, exact=True, conv_mode="f32_split")
    shared = ("w", "bias", "qm", "shift")
    checked = 0
    for key, v in tprog.params.items():
        if key.split("/")[-1] in shared or key.startswith("t"):
            np.testing.assert_array_equal(v, jprog.params[key], err_msg=key)
            assert v.dtype == jprog.params[key].dtype, key
            checked += 1
    assert checked >= 4
    for key, v in tprog.meta.items():
        if key.split("/")[-1] in ("x_zp", "w_zp", "qmin", "qmax", "out_zp",
                                  "rounding"):
            assert v == jprog.meta[key], key
    xs, want, _, _ = _goldens(name)
    fn = tprog.make_fn()
    for params in (tprog.params, {k: v for k, v in jprog.params.items()
                                  if k in tprog.params}):
        out = fn(params_from_jax(params), [torch.from_numpy(xs[0])])[0]
        np.testing.assert_array_equal(out.numpy(), want[0])


@pytest.mark.parametrize("name", SMALL + ["mobilenet_v2_int8"])
def test_every_op_matches_tflite(name):
    """Each op, fed TFLite's own inputs to it, reproduces TFLite's
    output tensor (the interpreter keeps every intermediate)."""
    path = _path(name)
    g = tparse(path)
    it = make_tfl_interpreter(path, experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    xs, _, _, _ = _goldens(name)
    prog = tbuild(g, range(len(g.ops)))
    params = params_from_jax(prog.params)
    for x in xs[:1 if name == "mobilenet_v2_int8" else 3]:
        it.set_tensor(it.get_input_details()[0]["index"], x)
        it.invoke()
        for op in g.ops:
            ctx = LowerCtx(g, params, prog.meta)
            for t in op.inputs:
                if t >= 0 and not g.tensor(t).is_constant:
                    ctx.set(t, torch.from_numpy(it.get_tensor(t).copy()))
            get_lowering(op.opname).trace(ctx, op)
            np.testing.assert_array_equal(
                ctx.arr(op.outputs[0]).numpy(), it.get_tensor(op.outputs[0]),
                err_msg=f"op {op.index} {op.opname}")


def test_full_width_mobilenet_v2_matches_goldens():
    """The published MobileNetV2 1.0/224 through the port's executor on
    the CPU: outputs and the logits below the SOFTMAX equal the TFLite
    goldens, at b1 and stacked."""
    xs, want, logits, logits_tid = _goldens("mobilenet_v2_int8")
    g = tparse(_path("mobilenet_v2_int8"))
    ex = ModelExecutor(0, g, 0, torch.device("cpu"))
    whole = ex.prepare_subgraph(range(len(g.ops)), [0])
    below = ex.prepare_subgraph(range(len(g.ops) - 1), [1])
    assert ex.output_ids(below) == (logits_tid,)
    np.testing.assert_array_equal(ex.execute(whole, [xs[0]])[0].numpy(),
                                  want[0])
    for i, outs in enumerate(ex.execute_batched(below, [[x] for x in xs])):
        np.testing.assert_array_equal(outs[0].numpy(), logits[i])
    assert len(np.unique(logits)) > 100  # the logits carry information
