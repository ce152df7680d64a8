"""The int8 decoder models served end to end by the PyTorch port on a CPU
worker, through the public API (RuntimeConfigBuilder -> Engine.create ->
register_model -> request_sync / request_async), against
tests/data/torch_ops_goldens.npz (tests/gen_torch_ops_goldens.py):

- FSRCNN x2 (fsrcnn_x2_small_int8, the published widths at 24x40) and
  tconv_int8, exact and fast numerics side by side on one engine: 0
  differing bytes against TFLite (exact) and band_tpu's fast path (fast);
- cnn_ops_int8 (exact): 0 against TFLite on every output computed in
  integers, within 1 quant unit of band_tpu where a float fallback op
  is on the output's path; attention_int8 (exact): within 2 quant units
  of TFLite, band_tpu's own bound (tests/test_model_families.py:59);
- the full-width FSRCNN (360x640 -> 720x1280) on the CPU executor, one
  request in each numerics, against the digests of TFLite's and
  band_tpu's fast outputs.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import band_tpu_torch as tb
from band_tpu_torch.backend.executor import ModelExecutor
from tests.gen_torch_goldens import golden_inputs, input_sha
from tests.gen_torch_ops_goldens import OPS_GOLDENS_PATH

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MAX_BATCH = 4


def _model(name):
    return tb.Model.from_path(os.path.join(DATA, f"{name}.tflite"))


def _goldens(name):
    z = np.load(OPS_GOLDENS_PATH)
    g = _model(name).graph
    td = g.tensor(g.inputs[0])
    n = len(z[f"{name}/exact0"]) if f"{name}/exact0" in z else \
        len(z[f"{name}/exact_sha"])
    xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype, n)
    assert input_sha(xs) == str(z[f"{name}/input_sha"])
    out = dict(xs=xs)
    for kind in ("exact", "fast", "tol"):
        got = [z[f"{name}/{kind}{i}"] for i in range(len(g.outputs))
               if f"{name}/{kind}{i}" in z]
        if got:
            out[kind] = got
    for kind in ("exact_sha", "fast_sha"):
        if f"{name}/{kind}" in z:
            out[kind] = [str(s) for s in z[f"{name}/{kind}"]]
    return out


def _engine():
    return tb.Engine.create(
        tb.RuntimeConfigBuilder()
        .add_scheduler(tb.SchedulerType.FIXED_WORKER)
        .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,),
                                  max_batch=MAX_BATCH))
        .profile_warmups(1).profile_runs(1)
        .build())


def _serve(eng, mid, xs):
    """Three sync requests, then a burst of 8 (batch windows)."""
    sync = [eng.request_sync(mid, [x]) for x in xs[:3]]
    ids = [eng.request_async(mid, [xs[i % len(xs)]]) for i in range(8)]
    return [(i, o) for i, o in enumerate(sync)] + \
        [(i % len(xs), eng.wait(j)) for i, j in enumerate(ids)]


def _held(outs, want, tol, i, what):
    assert len(outs) == len(want), what
    for k, (o, w) in enumerate(zip(outs, want)):
        t = int(tol[k]) if tol is not None else 0
        assert o.shape == w[i].shape and o.dtype == w[i].dtype, what
        if o.dtype.kind == "f":
            np.testing.assert_array_equal(o, w[i], err_msg=f"{what} {k}")
            continue
        d = np.abs(o.astype(np.int64) - w[i].astype(np.int64))
        assert int(d.max(initial=0)) <= t, (what, k, int(d.max()))


@pytest.mark.parametrize("name", ["fsrcnn_x2_small_int8", "tconv_int8"])
def test_exact_and_fast_served_side_by_side(name):
    gd = _goldens(name)
    eng = _engine()
    try:
        exact = eng.register_model(_model(name))
        fast = eng.register_model(_model(name), numerics="fast")
        assert eng.wait_buckets_ready(timeout=300)
        assert eng.model_record(exact).executors[0].exact
        assert not eng.model_record(fast).executors[0].exact
        for mid, kind in ((exact, "exact"), (fast, "fast")):
            served = _serve(eng, mid, gd["xs"])
            for i, outs in served:
                _held(outs, gd[kind], None, i, f"{name} {kind} request {i}")
        windows = eng.model_record(fast).executors[0].windows
        assert max(windows) > 1, "the burst ran no batch window"
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", ["cnn_ops_int8", "attention_int8"])
def test_structural_and_attention_models_served(name):
    gd = _goldens(name)
    eng = _engine()
    try:
        mid = eng.register_model(_model(name))
        assert eng.wait_buckets_ready(timeout=300)
        for i, outs in _serve(eng, mid, gd["xs"]):
            _held(outs, gd["exact"], gd["tol"], i, f"{name} request {i}")
    finally:
        eng.shutdown()
    assert max(int(t) for t in gd["tol"]) <= (2 if name == "attention_int8"
                                              else 1)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_full_width_fsrcnn_matches_digests(exact):
    """FSRCNN x2 at 360x640 through the CPU executor: the first golden
    request's 720x1280 output hashes to the golden digest."""
    name = "fsrcnn_x2_int8"
    gd = _goldens(name)
    g = _model(name).graph
    ex = ModelExecutor(0, g, 0, torch.device("cpu"), exact=exact)
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    (out,) = ex.execute(key, [gd["xs"][0]])
    assert tuple(out.shape) == (1, 720, 1280, 1)
    digest = hashlib.sha256(out.numpy().tobytes()).hexdigest()
    assert digest == gd["exact_sha" if exact else "fast_sha"][0]
