"""The request axis: a window stacks its requests on the leading axis of
every per-request tensor, and each op that works along a model's leading
axis (slices, packs, gathers, scatters, segment ops, space/batch moves,
...) runs per request behind it.  support_ops, support_ops2 (model
inputs [2, 6, 8]: leading extents above 1) and centernet_small_int8
(GATHER_ND with a batch index of 0) served in windows of 1, 2, 3 (padded
to 4), 4 and 8 requests through the executor equal the same requests
served one at a time, and band_tpu's program vmapped over the eight
requests, as its executor serves a window (under vmap a request's
outputs do not depend on its neighbours).

Tolerances: bool and integer outputs 0; float outputs rtol 2e-5, atol
2e-5 against solo and against band_tpu, as tests/test_torch_support_ops.py
states (on the CPU a window of LRN's pow takes another vector path than
one request, and oneDNN picks the 3-D conv's algorithm by batch size:
4e-9 and 4e-6 apart in a window of 2; every other float output equal).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from band_tpu.backend.program import build_program as jbuild
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ops import lowerings as L
from tests.test_torch_support_ops import _graphs, held, request_inputs

MODELS = ("support_ops", "support_ops2", "centernet_small_int8")
WINDOWS = (1, 2, 3, 4, 8)
SEEDS = tuple(100 + i for i in range(max(WINDOWS)))


@functools.lru_cache(maxsize=None)
def _executor(name):
    g = _graphs(name)[0]
    ex = ModelExecutor(0, g, 0, torch.device("cpu"))
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    return ex, key


@functools.lru_cache(maxsize=None)
def _band_tpu(name):
    """band_tpu's program vmapped over the requests of seeds SEEDS (its
    executor's window); a request's outputs do not depend on the others
    in its window, so each window below is held to these."""
    jg = _graphs(name)[1]
    prog = jbuild(jg, range(len(jg.ops)), exact=True, conv_mode="f32_split")
    vfn = jax.jit(jax.vmap(prog.make_fn(), in_axes=(None, 0)))
    feeds = [dict(zip(jg.inputs, request_inputs(name, s))) for s in SEEDS]
    outs = vfn(prog.params, [np.stack([f[t] for f in feeds])
                             for t in prog.input_ids])
    return prog.output_ids, [np.asarray(o) for o in outs]


@functools.lru_cache(maxsize=None)
def _solo(name, seed):
    ex, key = _executor(name)
    return [o.numpy() for o in ex.execute(key, _ordered(name, seed))]


def _ordered(name, seed):
    """A request's inputs in the program's input order."""
    ex, key = _executor(name)
    feeds = dict(zip(_graphs(name)[0].inputs, request_inputs(name, seed)))
    return [feeds[t] for t in ex.input_ids(key)]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", MODELS)
def test_window_equals_solo_and_band_tpu(name, window):
    ex, key = _executor(name)
    seeds = SEEDS[:window]
    outs = ex.execute_batched(key, [_ordered(name, s) for s in seeds])
    output_ids, band = _band_tpu(name)
    assert tuple(output_ids) == tuple(ex.output_ids(key))
    counts = {}
    for b, seed in enumerate(seeds):
        solo = _solo(name, seed)
        for j, o in enumerate(outs[b]):
            got = o.numpy()
            held(got, solo[j], f"request {b} output {j} solo", counts)
            held(got, band[j][b], f"request {b} output {j} band_tpu",
                 counts)


def test_topk_ties_in_a_window():
    """A window of four TOPK_V2 rows, three all tied (at different
    values) and one of few distinct values: each request's indices in
    index order among equal values, as its solo run and band_tpu's
    vmapped lax.top_k give them."""
    tg, jg = _graphs("centernet_small_int8")
    op = next(o for o in tg.ops if o.opname == "TOPK_V2")
    n = tg.tensor(op.inputs[0]).shape[-1]
    k = int(np.asarray(tg.tensor(op.inputs[1]).data).reshape(()))
    rng = np.random.default_rng(5)
    rows = np.stack([np.full((1, n), -128, np.int8),
                     np.full((1, n), 7, np.int8),
                     rng.integers(-1, 2, (1, n)).astype(np.int8),
                     np.full((1, n), 127, np.int8)])
    prog = tbuild(tg, [op.index])
    fn, params = prog.make_fn(), params_from_jax(prog.params)
    vals, idx = fn(params, [torch.from_numpy(rows.reshape(4, n))])
    jprog = jbuild(jg, [op.index], exact=True, conv_mode="f32_split")
    jvals, jidx = jax.vmap(jprog.make_fn(), in_axes=(None, 0))(
        jprog.params, [rows])
    for b in range(4):
        order = np.lexsort((np.arange(n), -rows[b, 0].astype(np.int64)))[:k]
        np.testing.assert_array_equal(idx[b].numpy(), order)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx[b, 0]))
        np.testing.assert_array_equal(vals[b].numpy(),
                                      np.asarray(jvals[b, 0]))
        solo_v, solo_i = fn(params, [torch.from_numpy(rows[b])])
        np.testing.assert_array_equal(solo_i.numpy(), idx[b:b + 1].numpy())
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(k))


def test_no_lowering_refuses_the_request_axis():
    """The refusal is gone: no lowering names the request axis in an
    error, and request_free marks only per-model values."""
    import inspect

    src = inspect.getsource(L)
    assert "_refuse_request_axis" not in src
    g = _graphs("centernet_small_int8")[0]
    free = L.request_free(g)
    gather = next(o for o in g.ops if o.opname == "GATHER_ND")
    # the gather's index is computed from the top-k of the request's
    # heatmap: per-request data, though one of its columns is a constant 0
    assert gather.inputs[1] not in free
    assert all(g.tensor(t).is_constant or t not in free
               for t in range(len(g.tensors)))
