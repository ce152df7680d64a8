"""The port's sharded programs on the CPU (band_tpu_torch/parallel/):
meshes of the virtual CPU devices, every comparison byte for byte.

 * the sharding spec of every param equals band_tpu's
   (band_tpu.parallel.sharding.param_shardings over its 8 virtual CPU
   devices), on mobilenet_v2_int8, effnetlite_int8 and fc_int8 at tp 2, 4
   and 8;
 * ShardedProgram and make_batched_fn equal the port's single-device
   program on meshes 1x2, 2x1, 2x2, 1x4 and 2x4, exact and fast numerics,
   on effnetlite_int8, resnetish_int8, fc_int8 and quant_act_int8, for a
   split window (4 requests), an unsplit one (3) and one request, with
   one gather per split op and row run;
 * they equal band_tpu's ShardedProgram and make_batched_fn (with
   band_tpu's params carried across, sharded) on every mesh shape and
   model of that grid (not every pairing: the single-device program
   closes the square), over the programs below each model's MEAN
   (band_tpu's MEAN rounds apart from TFLite's:
   tests/test_torch_models.py);
 * TRANSPOSE_CONV shards keep each channel's rounding group (cnn_ops_int8,
   12 channels: ruy 0-7, double 8-11), a depthwise conv with depth
   multiplier 2 reads each shard's own input channels, and the
   full-width MobileNetV2 on a 2x2 mesh gives TFLite's goldens.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from band_tpu.backend.program import build_program as jbuild
from band_tpu.parallel import mesh as jmesh
from band_tpu.parallel.sharding import param_shardings as jspecs
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ir.graph import Graph, OpNode, QuantParams, TensorDef
from band_tpu_torch.ops.lowerings import output_channels
from band_tpu_torch.parallel.mesh import (ShardedProgram, collective_stats,
                                          make_batched_fn, make_mesh,
                                          reset_collective_stats)
from band_tpu_torch.parallel.sharding import param_shardings
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from band_tpu_torch.tflite.schema import TensorType
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (2, 4)]
MODELS = ["effnetlite_int8", "resnetish_int8", "fc_int8", "quant_act_int8"]


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


@functools.lru_cache(maxsize=None)
def _graph(name):
    return tparse(_path(name))


@functools.lru_cache(maxsize=None)
def _prog(name, exact, ops=None):
    g = _graph(name)
    return tbuild(g, range(len(g.ops)) if ops is None else ops, exact=exact)


def _inputs(graph, prog, n, seed):
    """n requests' inputs of ``prog``, each of its model shape."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, dt in prog.input_specs:
        info = np.iinfo(dt)
        out.append(rng.integers(info.min, info.max + 1, (n,) + tuple(shape),
                                dtype=np.int64).astype(dt))
    return out


def _stack(xs, k=None):
    """The first k requests stacked on the leading axis, as torch."""
    return [torch.from_numpy(np.ascontiguousarray(
        x[:k].reshape((-1,) + x.shape[2:]))) for x in xs]


def _single(prog, stacked):
    return prog.make_fn()(params_from_jax(prog.params), stacked)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
        assert torch.equal(a, b)


def _before_mean(name):
    g = _graph(name)
    means = [op.index for op in g.ops if op.opname == "MEAN"]
    return tuple(range(means[0] if means else len(g.ops)))


# ----------------------------------------------------------------------
# the sharding spec
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("name",
                         ["mobilenet_v2_int8", "effnetlite_int8", "fc_int8"])
def test_sharding_spec_equals_band_tpu(name, tp):
    jg = jparse(_path(name))
    jprog = jbuild(jg, range(len(jg.ops)), exact=True, conv_mode="f32_split")
    want = jspecs(jprog, jmesh.make_mesh(jax.devices("cpu")[:tp], dp=1,
                                         tp=tp))
    prog = _prog(name, True)
    got = param_shardings(prog, make_mesh(dp=1, tp=tp))
    # band_tpu's dense-diagonal depthwise weights are a TPU routing choice
    # the port does not prepare (ops/lowerings.py)
    assert {k.rsplit("/", 1)[-1] for k in set(want) - set(got)} <= {
        "w_dense"}
    assert set(got) <= set(want)
    for k, spec in got.items():
        assert spec == tuple(want[k].spec), k
    # every split op's weights are sharded in band_tpu's spec too
    sp = ShardedProgram(prog, make_mesh(dp=1, tp=tp), place=False)
    for oi in sp.shards:
        assert got[f"op{oi}/w"] != (), oi


# ----------------------------------------------------------------------
# sharded programs against the single-device program
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("numerics", ["exact", "fast"])
@pytest.mark.parametrize("name", MODELS)
def test_sharded_program_equals_single_device(name, numerics, mesh_shape):
    dp, tp = mesh_shape
    prog = _prog(name, numerics == "exact")
    xs = _inputs(_graph(name), prog, 4, seed=len(name))
    mesh = make_mesh(dp=dp, tp=tp)
    sp = ShardedProgram(prog, mesh)
    if tp > 1 and name != "quant_act_int8":
        assert sp.shards, "no op split at tp > 1"
    for k in (4, 3, 1):
        reset_collective_stats()
        _equal(sp(_stack(xs, k)), _single(prog, _stack(xs, k)))
        rows = dp if k % dp == 0 else 1
        assert collective_stats()["gathers"] == len(sp.shards) * rows
    fn = make_batched_fn(prog, mesh, batch=4)
    outs = fn(sp.params, [[x[b] for x in xs] for b in range(4)])
    for b in range(4):
        _equal(list(outs[b]), _single(prog, [torch.from_numpy(x[b])
                                             for x in xs]))


def _dwconv_graph():
    """One int8 DEPTHWISE_CONV_2D, 4 input channels, depth multiplier 2,
    per-channel weight scales."""
    rng = np.random.default_rng(7)
    q = lambda s, z: QuantParams(np.asarray(s, np.float32),  # noqa: E731
                                 np.asarray(z, np.int64), 3)
    tensors = [
        TensorDef(0, "x", (1, 6, 6, 4), TensorType.INT8, q([0.05], [3])),
        TensorDef(1, "w", (1, 3, 3, 8), TensorType.INT8,
                  q(rng.uniform(0.01, 0.03, 8), np.zeros(8)),
                  rng.integers(-127, 128, (1, 3, 3, 8)).astype(np.int8)),
        TensorDef(2, "b", (8,), TensorType.INT32, None,
                  rng.integers(-500, 500, 8).astype(np.int32)),
        TensorDef(3, "y", (1, 6, 6, 8), TensorType.INT8, q([0.1], [-2])),
    ]
    op = OpNode(0, "DEPTHWISE_CONV_2D", [0, 1, 2], [3], {
        "padding": "SAME", "stride_h": 1, "stride_w": 1,
        "dilation_h": 1, "dilation_w": 1, "depth_multiplier": 2,
        "activation": "RELU6"})
    return Graph("dw", tensors, [op], [0], [3])


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_depthwise_shards_read_their_input_channels(tp):
    g = _dwconv_graph()
    assert output_channels(g, g.ops[0]) == (8, 2)
    prog = tbuild(g, [0])
    xs = _inputs(g, prog, 2, seed=tp)
    sp = ShardedProgram(prog, make_mesh(dp=1, tp=tp))
    # 8 channels split 4, 2 and 1 a device: a shard of 1 would cut a
    # multiplier group, and runs whole
    assert bool(sp.shards) == (tp < 8)
    _equal(sp(_stack(xs)), _single(prog, _stack(xs)))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("numerics", ["exact", "fast"])
@pytest.mark.parametrize("name", ["cnn_ops_int8", "tconv_int8"])
def test_transpose_conv_shards_equal_single_device(name, numerics,
                                                   mesh_shape):
    dp, tp = mesh_shape
    prog = _prog(name, numerics == "exact")
    g = _graph(name)
    tconvs = [op.index for op in g.ops if op.opname == "TRANSPOSE_CONV"]
    sp = ShardedProgram(prog, make_mesh(dp=dp, tp=tp))
    assert set(tconvs) & set(sp.shards)
    xs = _inputs(g, prog, 2, seed=3)
    _equal(sp(_stack(xs)), _single(prog, _stack(xs)))


# ----------------------------------------------------------------------
# against band_tpu's sharded programs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,numerics,mesh_shape", [
    ("effnetlite_int8", "exact", (2, 2)),
    ("resnetish_int8", "exact", (1, 4)),
    ("fc_int8", "fast", (2, 4)),
    ("fc_int8", "exact", (2, 1)),
    ("quant_act_int8", "fast", (1, 2)),
], ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_sharded_program_equals_band_tpu(name, numerics, mesh_shape):
    dp, tp = mesh_shape
    exact = numerics == "exact"
    ops = _before_mean(name)
    jg = jparse(_path(name))
    jprog = jbuild(jg, ops, exact=exact, conv_mode="f32_split")
    prog = _prog(name, exact, ops)
    xs = _inputs(_graph(name), prog, 4, seed=11)
    jm = jmesh.make_mesh(jax.devices("cpu")[:dp * tp], dp=dp, tp=tp)
    jsp = jmesh.ShardedProgram(jprog, jm, batch_size=2)
    want = [np.asarray(o) for o in jsp([x[:2] for x in xs])]
    mesh = make_mesh(dp=dp, tp=tp)
    for params in (None, jprog.params):  # the port's, band_tpu's carried
        got = ShardedProgram(prog, mesh, params=params)(
            _stack(xs, 2))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.reshape(a.shape))
    jfn = jmesh.make_batched_fn(jprog, jm, batch=4)
    jouts = jfn(jsp.params, tuple(tuple(x[b] for x in xs) for b in range(4)))
    sp = ShardedProgram(prog, mesh)
    outs = make_batched_fn(prog, mesh, batch=4)(
        sp.params, [[x[b] for x in xs] for b in range(4)])
    for b in range(4):
        for a, w in zip(outs[b], jouts[b]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_full_width_mobilenet_v2_on_a_2x2_mesh():
    name = "mobilenet_v2_int8"
    z = np.load(GOLDENS_PATH)
    g = _graph(name)
    td = g.tensor(g.inputs[0])
    want = z[f"{name}/output"]
    xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype, 2)
    prog = _prog(name, True)
    sp = ShardedProgram(prog, make_mesh(dp=2, tp=2))
    # 52 convs and the FC split in two, each row gathering them
    assert len(sp.shards) == 53
    reset_collective_stats()
    (out,) = sp([torch.from_numpy(xs.reshape((-1,) + xs.shape[2:]))])
    assert collective_stats()["gathers"] == 2 * 53
    np.testing.assert_array_equal(out.numpy(), want[:2].reshape(out.shape))
