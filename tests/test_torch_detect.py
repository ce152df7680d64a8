"""The CenterNet detector (tests/gen_torch_centernet_model.py) served
through the public API on a CPU worker: centernet_small_int8, the
CPU-sized sibling of the full-width CenterNet MobileNetV2 FPN 512x512
that chip_smoke.py's detect phase serves on the card (same FPN, heads
and in-graph decode: max pool, EQUAL, SELECT_V2, TOPK_V2, FLOOR_DIV and
FLOOR_MOD, PACK, GATHER_ND, CAST).

Goldens: tests/data/torch_detect_goldens.npz, 8 seeded requests: exact
outputs byte-equal to TFLite's (builtin kernels) and fast outputs
byte-equal to band_tpu's fast path, each at b1 (request_sync) and in a b8
window (one burst of 8 request_async); a b8 window of the requests in
reversed order equal to the solo outputs.  Tolerance 0 throughout: boxes
and scores are int8, classes int32.
"""

import os

import jax
import numpy as np
import pytest

import band_tpu_torch as tb
from band_tpu.backend.program import build_program as jbuild
from band_tpu.tflite.parser import parse_tflite_file as jparse
from tests.gen_torch_centernet_model import (CONFIGS, GOLDENS_PATH, SMALL,
                                             inputs, path_of, sha256)

N_OUT = 3


@pytest.fixture(scope="module")
def goldens():
    z = np.load(GOLDENS_PATH)
    side, *_, seed = CONFIGS[SMALL]
    xs = inputs(int(z[f"{SMALL}/seed"]), (1, side, side, 3))
    assert sha256(xs) == str(z[f"{SMALL}/input_sha"])
    return dict(xs=xs,
                exact=[z[f"{SMALL}/exact{j}"] for j in range(N_OUT)],
                fast=[z[f"{SMALL}/fast{j}"] for j in range(N_OUT)])


def _serve(numerics, xs):
    """b1 request_sync of every request, then one burst of all of them
    (a b8 window), then the burst reversed."""
    cfg = (tb.RuntimeConfigBuilder()
           .add_scheduler(tb.SchedulerType.FIXED_WORKER)
           .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                     device_ids=(0,), max_batch=8))
           .profile_warmups(1).profile_runs(1)
           .numerics(numerics)
           .build())
    eng = tb.Engine.create(cfg)
    try:
        mid = eng.register_model(tb.Model.from_path(path_of(SMALL)))
        assert eng.wait_buckets_ready(timeout=120)
        ex = eng.model_record(mid).executors[0]
        solo = [eng.request_sync(mid, [x]) for x in xs]
        runs = []
        for order in (range(len(xs)), reversed(range(len(xs)))):
            order = list(order)
            before = dict(ex.windows)
            ids = [eng.request_async(mid, [xs[i]]) for i in order]
            outs = [eng.wait(j) for j in ids]
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            runs.append((order, outs, windows))
        return solo, runs
    finally:
        eng.shutdown()


@pytest.mark.parametrize("numerics", ["exact", "fast"])
def test_detector_matches_its_goldens(goldens, numerics):
    xs = goldens["xs"]
    want = goldens[numerics]
    solo, runs = _serve(numerics, xs)
    for i, outs in enumerate(solo):
        assert len(outs) == N_OUT
        for j, o in enumerate(outs):
            o = np.asarray(o)
            assert o.dtype == want[j].dtype and o.shape == want[j][i].shape
            np.testing.assert_array_equal(
                o, want[j][i], err_msg=f"{numerics} b1 request {i} out {j}")
    for order, outs, windows in runs:
        assert max(windows) > 1, windows  # the burst ran a batch window
        for i, req in zip(order, outs):
            for j, o in enumerate(req):
                np.testing.assert_array_equal(
                    np.asarray(o), np.asarray(solo[i][j]),
                    err_msg=f"{numerics} window request {i} out {j}")


def test_band_tpu_exact_matches_tflite(goldens):
    """The reference itself: band_tpu's exact program gives TFLite's
    bytes on the small detector (so the port's TFLite goldens are
    band_tpu's too)."""
    g = jparse(path_of(SMALL))
    prog = jbuild(g, range(len(g.ops)), exact=True, conv_mode="f32_split")
    fn = jax.jit(prog.make_fn())
    pos = [prog.output_ids.index(t) for t in g.outputs]
    for i, x in enumerate(goldens["xs"]):
        outs = fn(prog.params, [x])
        for j in range(N_OUT):
            np.testing.assert_array_equal(np.asarray(outs[pos[j]]),
                                          goldens["exact"][j][i])


def test_full_width_model_is_the_documented_one():
    """The full-width file: 512x512x3 int8 in; boxes [1, 100, 4] int8,
    scores [1, 100] int8, classes [1, 100] int32 out; its decode ops."""
    from band_tpu_torch.tflite.parser import parse_tflite_file

    g = parse_tflite_file(path_of("centernet_mnv2_fpn_int8"))
    td = g.tensor(g.inputs[0])
    assert (tuple(td.shape), td.dtype) == ((1, 512, 512, 3), np.int8)
    outs = [(tuple(g.tensor(t).shape), g.tensor(t).dtype) for t in g.outputs]
    assert outs == [((1, 100, 4), np.int8), ((1, 100), np.int8),
                    ((1, 100), np.int32)]
    hist = g.op_histogram()
    for name in ("MAX_POOL_2D", "EQUAL", "SELECT_V2", "TOPK_V2", "FLOOR_DIV",
                 "FLOOR_MOD", "PACK", "GATHER_ND", "CAST"):
        assert hist.get(name, 0) >= 1, name
    topk = next(op for op in g.ops if op.opname == "TOPK_V2")
    assert g.tensor(topk.inputs[0]).shape == (1, 128 * 128 * 90)
