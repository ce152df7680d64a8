"""The op set ported for the int8 decoder and attention models, op by op:
each op of tconv_int8, fsrcnn_x2_small_int8, cnn_ops_int8 and
attention_int8 that this port registers beside the main path runs as a
one-op program of the port and of band_tpu (conv_mode="f32_split"), both
fed the TFLite interpreter's own input tensors to it
(experimental_preserve_all_tensors=True), and is compared with band_tpu's
output and with TFLite's.

Tolerances:
- ops computed in integers, and the structural ops: 0 against band_tpu
  and 0 against TFLite;
- TRANSPOSE_CONV, PRELU and LEAKY_RELU: 0 against TFLite, the only
  reference (band_tpu rounds them differently: ROADMAP faults C3, C4);
- the float fallbacks (RESIZE_BILINEAR, BATCH_MATMUL, SQUARED_DIFFERENCE
  and the float unary table): within 1 quant unit of band_tpu and of
  TFLite on quantized outputs (the test prints how many bytes differ),
  and within rtol 1e-5, atol 1e-6 of band_tpu on float outputs (torch's
  transcendental functions are not XLA's); any other float output
  exactly.

GELU is emitted by no model here (the converter decomposes it), so the
unary table is also run on the int8 and the float input of cnn_ops_int8's
LOG and COS with the op renamed.
"""

import copy
import functools
import os

import jax
import numpy as np
import pytest
import torch

from band_tpu.backend.program import build_program as jbuild
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.errors import LoweringError
from band_tpu_torch.ops import lowerings as L
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODELS = ("tconv_int8", "fsrcnn_x2_small_int8", "cnn_ops_int8",
          "attention_int8")
SEEDS = (0, 1)
TFLITE_ONLY = {"TRANSPOSE_CONV", "PRELU", "LEAKY_RELU"}
FLOAT_FALLBACK = {"RESIZE_BILINEAR", "BATCH_MATMUL",
                  "SQUARED_DIFFERENCE"} | set(L._FLOAT_UNARY)
NEW_OPS = TFLITE_ONLY | FLOAT_FALLBACK | {
    "SHAPE", "STRIDED_SLICE", "PACK", "SLICE", "TRANSPOSE", "RELU", "RELU6",
    "CONCATENATION", "PAD", "PADV2", "MIRROR_PAD", "SPLIT", "SPLIT_V",
    "DEPTH_TO_SPACE", "SPACE_TO_DEPTH", "RESIZE_NEAREST_NEIGHBOR"}


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return tparse(_path(name)), jparse(_path(name))


@functools.lru_cache(maxsize=None)
def _tensors(name, seed):
    """Every tensor of one TFLite run on a seeded int8 input."""
    it = make_tfl_interpreter(_path(name),
                              experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    ind = it.get_input_details()[0]
    rng = np.random.default_rng(seed)
    it.set_tensor(ind["index"], rng.integers(-128, 128, size=ind["shape"])
                  .astype(ind["dtype"]))
    it.invoke()
    g = _graphs(name)[0]
    return {t: np.array(it.get_tensor(t)) for t in range(len(g.tensors))
            if not g.tensor(t).is_constant and g.tensor(t).shape is not None
            and _has(it, t)}


def _has(it, t):
    try:
        it.get_tensor(t)
        return True
    except ValueError:
        return False


def _cases():
    out = []
    for name in MODELS:
        g = tparse(_path(name))
        for op in g.ops:
            if op.opname in NEW_OPS:
                out.append(pytest.param(name, op.index,
                                        id=f"{name}-{op.index}-{op.opname}"))
    return out


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


def _held(got, want, what, tol, counts):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype.kind == "f":
        counts[what] = int((got != want).sum())
        np.testing.assert_allclose(got, want, rtol=tol and 1e-5,
                                   atol=tol and 1e-6, err_msg=what)
        return
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    counts[what] = int((d > 0).sum())
    assert int(d.max(initial=0)) <= tol, (what, int(d.max()))


@pytest.mark.parametrize("name,index", _cases())
def test_op_matches_band_tpu_and_tflite(name, index):
    tg, jg = _graphs(name)
    op = tg.ops[index]
    tol = 1 if op.opname in FLOAT_FALLBACK else 0
    counts = {}
    for seed in SEEDS:
        feeds = _tensors(name, seed)
        tprog, touts = _run_port(tg, [index], feeds)
        for t, got in zip(tprog.output_ids, touts):
            _held(got, feeds[t], f"seed {seed} TFLite tensor {t}", tol,
                  counts)
        if op.opname in TFLITE_ONLY:
            continue
        jprog, jouts = _run_band_tpu(jg, [index], feeds)
        assert tprog.output_ids == jprog.output_ids
        for t, got, want in zip(tprog.output_ids, touts, jouts):
            _held(got, want, f"seed {seed} band_tpu tensor {t}", tol, counts)
    print(f"{name} op {index} {op.opname}: differing bytes {counts}")


@pytest.mark.parametrize("opname", sorted(L._FLOAT_UNARY))
@pytest.mark.parametrize("source", [4, 12], ids=["int8", "float"])
def test_float_unary_table_matches_band_tpu(opname, source):
    """Every op of the float unary table on cnn_ops_int8's LOG input
    (int8 in and out, positive) and COS input (float32 in and out), the
    op renamed in both packages' graphs."""
    tg, jg = (copy.deepcopy(g) for g in _graphs("cnn_ops_int8"))
    assert tg.ops[source].opname in ("LOG", "COS")
    tg.ops[source].opname = jg.ops[source].opname = opname
    counts = {}
    for seed in SEEDS:
        feeds = _tensors("cnn_ops_int8", seed)
        tprog, (got,) = _run_port(tg, [source], feeds)
        _, (want,) = _run_band_tpu(jg, [source], feeds)
        _held(got, want, f"seed {seed}", 1, counts)
    print(f"{opname} on op {source}'s input: differing bytes {counts}")


def test_every_new_op_is_registered_and_covered():
    from band_tpu_torch.ops.registry import REGISTRY

    assert NEW_OPS <= set(REGISTRY)
    seen = {tparse(_path(n)).ops[i].opname
            for n in MODELS for i in range(len(tparse(_path(n)).ops))}
    # every new op but GELU (test_float_unary_table_matches_band_tpu) is
    # in one of the models
    assert NEW_OPS - seen == {"GELU"}


# --------------------------------------------------------------------------
# the request axis
# --------------------------------------------------------------------------

def _one_op(name, opname):
    g = copy.deepcopy(_graphs(name)[0])
    return g, next(op for op in g.ops if op.opname == opname)


def _reshape(tid, shape):
    """Give tensor ``tid`` the model shape ``shape`` (a leading extent
    above 1, which the ops along axis 0 need)."""
    def edit(g, op):
        g.tensor(tid).shape = tuple(shape)
    return edit


def _const(pos, value):
    def edit(g, op):
        g.tensor(op.inputs[pos]).data = np.asarray(value, np.int32)
    return edit


def _chain(*edits):
    def edit(g, op):
        for e in edits:
            e(g, op)
    return edit


def _inputs_to(tids):
    def edit(g, op):
        op.inputs[:] = list(tids)
    return edit


@pytest.mark.parametrize("opname,edit", [
    ("CONCATENATION", _chain(_inputs_to([69, 38]),
                             lambda g, op: op.options.update(axis=0))),
    ("CONCATENATION", _chain(_inputs_to([69, 38]),
                             lambda g, op: op.options.update(axis=-4))),
    ("PACK", None),
    ("SPLIT", _chain(_reshape(32, (2, 12, 6, 8)), _const(0, 0))),
    ("SPLIT_V", _chain(_reshape(38, (8, 12, 12, 1)), _const(2, 0))),
    ("TRANSPOSE", _const(1, [1, 0, 2, 3])),
    ("PAD", _const(1, [[1, 0], [0, 0], [0, 0], [0, 0]])),
    ("SLICE", _chain(_reshape(32, (2, 12, 6, 8)), _const(1, [1, 0, 0, 0]),
                     _const(2, [1, 6, 4, 8]))),
    ("STRIDED_SLICE", _chain(
        lambda g, op: op.options.update(shrink_axis_mask=1),
        lambda g, op: setattr(g.tensor(op.outputs[0]), "shape", (5, 4, 5)))),
], ids=["concat0", "concat-4", "pack", "split", "split_v", "transpose",
        "pad", "slice", "strided_slice"])
def test_request_axis_is_refused(opname, edit):
    """Ops that index, split, pack, pad, permute or concatenate along the
    leading axis of per-request data were refused when a program was
    built; now each runs per request.  Edited one-op programs (axis 0,
    leading extents above 1) run a window of four seeded requests: equal
    to the requests run one at a time, and to band_tpu's program vmapped
    over them (tolerance 0)."""
    name = "attention_int8" if opname == "TRANSPOSE" else "cnn_ops_int8"
    if opname == "PACK":
        # two copies of a TRANSPOSE_CONV's data, packed on axis 0
        g, op = _one_op("tconv_int8", "PACK")
        op.inputs[:] = [g.ops[3].inputs[2]] * 2
        op.options.update(axis=0)
    else:
        g, op = _one_op(name, opname)
        edit(g, op)
    jg = copy.deepcopy(g)
    tprog = tbuild(g, [op.index])
    fn, params = tprog.make_fn(), params_from_jax(tprog.params)
    rng = np.random.default_rng(op.index)
    reqs = [[_random(rng, g.tensor(t)) for t in tprog.input_ids]
            for _ in range(4)]
    window = fn(params, [torch.from_numpy(np.concatenate(col))
                         for col in zip(*reqs)])
    solo = [fn(params, [torch.from_numpy(x) for x in r]) for r in reqs]
    jprog = jbuild(jg, [op.index], exact=True, conv_mode="f32_split")
    vmapped = jax.vmap(jprog.make_fn(), in_axes=(None, 0))(
        jprog.params, [np.stack(col) for col in zip(*reqs)])
    assert tprog.output_ids == jprog.output_ids
    for j, w in enumerate(window):
        parts = w.numpy().reshape((4, -1) + tuple(w.shape[1:]))
        for b in range(4):
            np.testing.assert_array_equal(parts[b], solo[b][j].numpy())
            np.testing.assert_array_equal(
                solo[b][j].numpy(), np.asarray(vmapped[j][b]))


def _random(rng, td):
    if td.dtype.kind == "f":
        return rng.standard_normal(td.shape).astype(td.dtype)
    info = np.iinfo(td.dtype)
    return rng.integers(info.min, info.max + 1, size=td.shape,
                        dtype=np.int64).astype(td.dtype)


def test_shape_prelude_is_not_per_request():
    """SHAPE -> STRIDED_SLICE -> PACK slices and packs axis 0 of a shape
    vector, which carries no requests: built and run as values of the
    model's shape, also for a stacked window."""
    tg = _graphs("tconv_int8")[0]
    prog = tbuild(tg, [0, 1, 2])
    x = torch.zeros((4, 5, 5, 8), dtype=torch.int8)  # four requests
    outs = prog.make_fn()(params_from_jax(prog.params), [x])
    pack = prog.output_ids.index(tg.ops[2].outputs[0])
    np.testing.assert_array_equal(outs[pack].numpy(), [1, 11, 11, 16])
    assert tg.ops[2].outputs[0] in L.request_free(tg)
    assert tg.ops[3].outputs[0] not in L.request_free(tg)


def test_batch_matmul_refuses_tf32(monkeypatch):
    """On the card BATCH_MATMUL runs only with TF32 off."""
    tg = _graphs("attention_int8")[0]
    op = next(o for o in tg.ops if o.opname == "BATCH_MATMUL")

    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    feeds = _tensors("attention_int8", 0)
    ctx = L.LowerCtx(tg, {}, {})
    for t in op.inputs:
        ctx.set(t, torch.from_numpy(feeds[t]).as_subclass(CudaLike))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(LoweringError, match="TF32"):
        L._batch_matmul(ctx, op)


# --------------------------------------------------------------------------
# the forms of A11 that no tests/data model holds, as one-op models
# (tests/gen_torch_oneop_models.py) against TFLite and band_tpu
# --------------------------------------------------------------------------

def _oneop_cases():
    """(label, maker, band_tpu's relation to TFLite): "equal", "differs"
    (a fault: C4 int8 PRELU, C11 per-channel QUANTIZE) or "fails" (C10:
    band_tpu ignores the ellipsis and new-axis masks, so its result does
    not take the output's shape).  A maker gives (model bytes,
    inputs)."""
    from tests.gen_torch_oneop_models import one_op, options, spec

    rng = np.random.default_rng(15)
    xf = rng.uniform(-1, 1, (1, 4, 5, 3)).astype(np.float32)
    af = rng.uniform(0, 0.5, (4, 5, 3)).astype(np.float32)
    xq = rng.integers(-128, 128, (1, 4, 5, 3)).astype(np.int8)
    aq = rng.integers(-128, 128, (4, 5, 3)).astype(np.int8)
    qx = dict(scale=0.05, zero_point=3)
    qa = dict(scale=0.004, zero_point=-5)
    qo = dict(scale=0.04, zero_point=-2)
    xs = np.arange(60, dtype=np.float32).reshape(1, 3, 4, 5)
    w = rng.integers(-127, 128, (3, 4)).astype(np.int8)
    wa = rng.integers(-128, 128, (1, 3, 4)).astype(np.int8)
    xp = rng.uniform(-1, 1, (1, 2, 3)).astype(np.float32)
    seg = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    ids = np.array([0, 0, 1, 2, 2], np.int32)

    def prelu(x, a, quant, const):
        kw = (qx, qa, qo) if quant else ({}, {}, {})
        dt = "int8" if quant else "float32"
        return (one_op("PRELU", [spec(x.shape, dt, **kw[0]),
                                 spec(a.shape, dt, a if const else None,
                                      **kw[1])],
                       [spec(x.shape, dt, **kw[2])]),
                [x] if const else [x, a])

    def ss(begin, end, strides, out, **masks):
        v = [spec([len(begin)], "int32", np.array(b, np.int32))
             for b in (begin, end, strides)]
        return (one_op("STRIDED_SLICE", [spec(xs.shape, "float32")] + v,
                       [spec(out, "float32")],
                       options("StridedSlice", **masks),
                       "StridedSliceOptions"), [xs])

    pc = dict(scale=[0.1, 0.2, 0.3], zero_point=[0, 1, -2])
    return [
        ("prelu-float-runtime", lambda: prelu(xf, af, False, False), "equal"),
        ("prelu-float-hwc", lambda: prelu(xf, af, False, True), "equal"),
        ("prelu-int8-runtime", lambda: prelu(xq, aq, True, False), "differs"),
        ("prelu-int8-hwc", lambda: prelu(xq, aq, True, True), "differs"),
        ("strided-negative", lambda: ss([0, 2, 3, 4], [1, 0, 0, 0],
                                        [1, -1, -2, -1], [1, 2, 2, 4]),
         "equal"),
        ("strided-negative-masked", lambda: ss(
            [0, 0, 0, 4], [1, 0, 4, 0], [1, -1, 1, -2], [1, 3, 4, 2],
            beginMask=2, endMask=2), "equal"),
        ("strided-ellipsis", lambda: ss([0, 1], [0, 3], [1, 1], [1, 3, 4, 2],
                                        ellipsisMask=1), "fails"),
        ("strided-new-axis", lambda: ss([0, 0, 0], [1, 2, 3], [1, 1, 1],
                                        [1, 1, 2, 4, 5], newAxisMask=2),
         "fails"),
        ("dequantize-per-channel-constant", lambda: (one_op(
            "DEQUANTIZE", [spec(w.shape, "int8", w, qdim=0, **pc)],
            [spec(w.shape, "float32")]), []), "equal"),
        ("dequantize-per-channel", lambda: (one_op(
            "DEQUANTIZE", [spec(wa.shape, "int8", qdim=1, **pc)],
            [spec(wa.shape, "float32")]), [wa]), "equal"),
        ("quantize-per-channel", lambda: (one_op(
            "QUANTIZE", [spec(xp.shape, "float32")],
            [spec(xp.shape, "int8", scale=[0.01, 0.02, 0.03],
                  zero_point=[0, 1, 2], qdim=2)]), [xp]), "differs"),
        ("segment-sum-runtime-ids", lambda: (one_op(
            "SEGMENT_SUM", [spec(seg.shape, "float32"), spec([5], "int32")],
            [spec([3, 3], "float32")]), [seg, ids]), "equal"),
    ]


_ONEOP = {label: (make, band) for label, make, band in _oneop_cases()}


@pytest.mark.parametrize("label", list(_ONEOP))
def test_one_op_form_matches_tflite(label, tmp_path):
    """The port equals TFLite 2.21 exactly on each form (floats too: the
    same float32 operations); band_tpu as the case says (faults C4, C10,
    C11 in ROADMAP.md)."""
    make, band = _ONEOP[label]
    model, feeds = make()
    path = str(tmp_path / "m.tflite")
    with open(path, "wb") as f:
        f.write(model)
    it = make_tfl_interpreter(path)
    it.allocate_tensors()
    for d, v in zip(it.get_input_details(), feeds):
        it.set_tensor(d["index"], v)
    it.invoke()
    want = it.get_tensor(it.get_output_details()[0]["index"])
    tg, jg = tparse(path), jparse(path)
    inputs = dict(zip(tg.inputs, feeds))
    _, (got,) = _run_port(tg, [0], inputs)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if band == "fails":
        with pytest.raises(Exception):
            _run_band_tpu(jg, [0], inputs)
        return
    _, (ref,) = _run_band_tpu(jg, [0], inputs)
    assert np.array_equal(ref, want) == (band == "equal")


def test_band_tpu_cannot_run_runtime_int8_fc_weights():
    """Why runtime int8 FULLY_CONNECTED weights stay refused
    (test_torch_float.py::test_runtime_fc_weights_are_refused): band_tpu
    prepares nothing for them and its lowering fails on the missing
    weights."""
    g8 = copy.deepcopy(jparse(_path("fc_int8")))
    op = next(op for op in g8.ops if op.opname == "FULLY_CONNECTED")
    g8.tensor(op.inputs[1]).data = None
    feeds = {t: _random(np.random.default_rng(0), g8.tensor(t))
             for t in op.inputs[:2]}
    with pytest.raises(KeyError):
        _run_band_tpu(g8, [op.index], feeds)
