"""FSRCNN x2 in float32 and with dynamic-range quantization in the
PyTorch port, on the CPU, against band_tpu and the TFLite interpreter:
the float and hybrid TRANSPOSE_CONV.

The models are tests/gen_torch_fsrcnn_float_models.py's 24x40 twins of
the 360x640 ones that chip_smoke.py's srfloat phase serves.  Tolerances:

- float32: every output within 1e-5 x max|want| of band_tpu
  (conv_mode="f32_split": float32 sums in another order) and within
  1e-4 x max|golden| of TFLite;
- dynamic range: within 1e-4 x max|golden| of TFLite, op by op (each op
  fed TFLite's own preserved input tensors) and end to end; band_tpu is
  no reference for its TRANSPOSE_CONV (fault C9 in ROADMAP.md: it
  convolves the weight codes without their scale, more than 1.0 off
  TFLite here, while its float32 TRANSPOSE_CONV agrees with TFLite);
- windows of 1 to 8 requests equal each request served alone: exactly
  for the hybrid deconv (each request quantized by its own range);
- qconv2d_hybrid_plain: equal to the integer form computed by hand.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

import band_tpu_torch as bt
from band_tpu.backend.program import build_program as jbuild
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ops import kernels as K
from band_tpu_torch.ops import lowerings as L
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter
from tests.gen_torch_fsrcnn_float_models import (FULL, REQUESTS,
                                                 SRFLOAT_GOLDENS_PATH,
                                                 path_of, sr_inputs)

FLOAT, DYNRANGE = "fsrcnn_x2_small_float", "fsrcnn_x2_small_dynrange"
H, W = 24, 40
SEEDS = (0, 1)
REL_BAND_TPU, REL_TFLITE = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU ops: the test workers
    share the cores, and torch's thread pool on busy cores is far slower
    than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _graph(name):
    return tparse(path_of(name))


@functools.lru_cache(maxsize=None)
def _tflite(name, seed):
    """The request of ``seed`` and every tensor TFLite computes for it."""
    x = sr_inputs(seed, 1, H, W)
    it = make_tfl_interpreter(path_of(name),
                              experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    g = _graph(name)
    out = {}
    for t in range(len(g.tensors)):
        if not g.tensor(t).is_constant:
            try:
                out[t] = np.array(it.get_tensor(t))
            except ValueError:
                pass
    return x, out


@functools.lru_cache(maxsize=None)
def _program(name, ops=None):
    g = _graph(name)
    prog = tbuild(g, range(len(g.ops)) if ops is None else ops)
    return prog, params_from_jax(prog.params), prog.make_fn()


def _run(name, x, ops=None):
    prog, params, fn = _program(name, ops)
    with torch.inference_mode():
        return fn(params, [torch.from_numpy(x)])[0].numpy()


def _band_tpu(name, feeds, ops=None):
    g = jparse(path_of(name))
    prog = jbuild(g, range(len(g.ops)) if ops is None else ops, exact=True,
                  conv_mode="f32_split")
    return np.asarray(jax.jit(prog.make_fn())(
        prog.params, [feeds[t] for t in prog.input_ids])[0])


def _within(got, want, rel):
    d = float(np.abs(got.astype(np.float64) - want).max())
    assert got.shape == want.shape and d <= rel * float(np.abs(want).max()), \
        (d, rel * float(np.abs(want).max()))
    return d


@pytest.mark.parametrize("seed", SEEDS)
def test_float_fsrcnn_matches_band_tpu_and_tflite(seed):
    x, tensors = _tflite(FLOAT, seed)
    g = _graph(FLOAT)
    got = _run(FLOAT, x)
    _within(got, tensors[g.outputs[0]], REL_TFLITE)
    _within(got, _band_tpu(FLOAT, {g.inputs[0]: x}), REL_BAND_TPU)


def _op_cases():
    g = _graph(DYNRANGE)
    return [op.index for op in g.ops
            if op.opname not in ("SHAPE", "STRIDED_SLICE", "PACK")]


@pytest.mark.parametrize("index", _op_cases())
def test_dynrange_op_matches_tflite(index):
    """Each op of the dynamic-range model fed TFLite's own input tensors:
    within 1e-4 x max|TFLite's output| (the hybrid convs and the hybrid
    deconv quantize per request; the PReLUs and 1x1 convs are float)."""
    g = _graph(DYNRANGE)
    _, tensors = _tflite(DYNRANGE, SEEDS[0])
    prog, params, fn = _program(DYNRANGE, (index,))
    with torch.inference_mode():
        got = fn(params, [torch.from_numpy(tensors[t])
                          for t in prog.input_ids])[0].numpy()
    _within(got, tensors[g.ops[index].outputs[0]], REL_TFLITE)


def _deconv(g):
    return next(o for o in g.ops if o.opname == "TRANSPOSE_CONV")


@pytest.mark.parametrize("seed", SEEDS)
def test_dynrange_fsrcnn_matches_tflite(seed):
    """End to end within 1e-4 x max|golden| of TFLite at every output
    pixel that no flipped code of the deconv's quantized input reaches.
    The deconv quantizes its float input per request; its input here
    differs from TFLite's by float rounding alone (within 1e-5 x max:
    the float 1x1 convs and PReLUs sum in another order), and where an
    input value sits that close to a rounding boundary its code flips by
    one.  A flip moves each output pixel in its 9x9 reach by up to
    scale * |w| (ROADMAP Watch: op 17, request of seed 0, 4.8e-4 x max).
    Checked: the flips are of one code and fewer than 1 in 1,000."""
    from band_tpu_torch.ops import quant as Q

    g = _graph(DYNRANGE)
    op = _deconv(g)
    x, tensors = _tflite(DYNRANGE, seed)
    want = tensors[g.outputs[0]]
    got = _run(DYNRANGE, x)
    ref_in = tensors[op.inputs[2]]
    port_in = _run(DYNRANGE, x, tuple(range(op.index - 3)))
    _within(port_in, ref_in, REL_BAND_TPU)
    codes = []
    for v in (port_in, ref_in):
        q, zp, _ = Q.asym_quant_rows(torch.from_numpy(v))
        codes.append((q - zp).numpy())
    flips = codes[0] != codes[1]
    assert np.abs(codes[0] - codes[1]).max() <= 1
    assert flips.sum() < 1e-3 * flips.size
    reach = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(flips.any(-1).astype(np.float32))[:, None],
        torch.ones(1, 1, 9, 9), stride=2, padding=3)[:, 0, :48, :80]
    free = reach.numpy() == 0
    d = np.abs(got.astype(np.float64) - want)[..., 0]
    assert float(d[free].max()) <= REL_TFLITE * float(np.abs(want).max())


def test_band_tpu_hybrid_transpose_conv_is_wrong():
    """Fault C9: band_tpu's hybrid TRANSPOSE_CONV (band_tpu/ops/
    lowerings.py:2133-2134) convolves the int8 weight codes as floats,
    without their scale: on TFLite's own input it is more than 1.0 off
    TFLite's output, where the port is within 1e-4 x max|golden|; its
    float32 TRANSPOSE_CONV agrees with TFLite (within 1e-5 x max)."""
    for name, band_ok in ((DYNRANGE, False), (FLOAT, True)):
        g = _graph(name)
        op = next(o for o in g.ops if o.opname == "TRANSPOSE_CONV")
        _, tensors = _tflite(name, SEEDS[0])
        want = tensors[op.outputs[0]]
        feeds = {t: tensors[t] for t in op.inputs if t in tensors}
        band = _band_tpu(name, feeds, (op.index,))
        d = float(np.abs(band.astype(np.float64) - want).max())
        if band_ok:
            assert d <= REL_BAND_TPU * float(np.abs(want).max())
        else:
            assert d > 1.0, d
        prog, params, fn = _program(name, (op.index,))
        with torch.inference_mode():
            got = fn(params, [torch.from_numpy(tensors[t])
                              for t in prog.input_ids])[0].numpy()
        _within(got, want, REL_TFLITE)


@pytest.mark.parametrize("name", [FLOAT, DYNRANGE])
def test_windows_equal_solo(name):
    """Windows of 2, 3 and 8 requests (stacked on the leading axis) equal
    each request alone: exactly with dynamic range (each request
    quantized by its own range; a request scaled by 1000 beside the
    others), within 1e-5 x max|out| in float32 (the CPU's batched float
    convs sum in another order than a single request's: 1.8e-6 x max
    seen)."""
    xs = sr_inputs(7, 8, H, W)
    xs[3] *= 1000.0
    solo = np.concatenate([_run(name, xs[i:i + 1]) for i in range(8)])
    for b in (2, 3, 8):
        got = _run(name, xs[:b])
        if name == DYNRANGE:
            np.testing.assert_array_equal(got, solo[:b])
        else:
            for i in range(b):
                _within(got[i:i + 1], solo[i:i + 1], REL_BAND_TPU)


def test_engine_serves_both_models_on_a_cpu_worker():
    """Both small models through the public API on a CPU worker (sync and
    a burst): every output within 1e-5 x max of the program run alone,
    and the float32 model's within 1e-4 x max|golden| of TFLite (the
    dynamic-range model's relation to TFLite end to end is
    test_dynrange_fsrcnn_matches_tflite's)."""
    eng = bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.CPU, device_ids=(0,),
                                  max_batch=4))
        .build())
    try:
        for name in (FLOAT, DYNRANGE):
            mid = eng.register_model(bt.Model.from_path(path_of(name)))
            xs = {s: _tflite(name, s)[0] for s in SEEDS}
            alone = {s: _run(name, xs[s]) for s in SEEDS}
            golden = {s: _tflite(name, s)[1][_graph(name).outputs[0]]
                      for s in SEEDS}
            served = [(s, eng.request_sync(mid, [xs[s]])[0]) for s in SEEDS]
            ids = [(s, eng.request_async(mid, [xs[s]]))
                   for s in SEEDS + SEEDS]
            served += [(s, eng.wait(j)[0]) for s, j in ids]
            for s, out in served:
                _within(out, alone[s], REL_BAND_TPU)
                if name == FLOAT:
                    _within(out, golden[s], REL_TFLITE)
    finally:
        eng.shutdown()


def test_full_width_goldens():
    """The goldens of the srfloat phase: each full-width model's first
    request on the port's CPU path within the card's gate (max(2 x the
    reference deviation, 1e-4 x max|golden|) at the stored positions);
    the positions distinct; the data under 1 MB with the models."""
    z = np.load(SRFLOAT_GOLDENS_PATH)
    pos = z["positions"]
    assert len(np.unique(pos)) == len(pos) == 16384
    assert pos.min() >= 0 and pos.max() < 720 * 1280
    size = os.path.getsize(SRFLOAT_GOLDENS_PATH) + sum(
        os.path.getsize(path_of(n)) for n in FULL + (FLOAT, DYNRANGE))
    assert size < 1 << 20
    for name in FULL:
        x = sr_inputs(int(z[f"{name}/seed"]), REQUESTS, 360, 640)[:1]
        out = _run(name, x).reshape(-1)[pos]
        d = float(np.abs(out.astype(np.float64) - z[f"{name}/tflite"][0])
                  .max())
        assert d <= max(2 * float(z[f"{name}/dev"][0]),
                        1e-4 * float(z[f"{name}/max"][0]))


def test_chip_smoke_makes_the_same_frames():
    import chip_smoke

    np.testing.assert_array_equal(chip_smoke.sr_inputs(11, 2, 24, 40),
                                  sr_inputs(11, 2, 24, 40))


def test_qconv2d_hybrid_plain_is_the_integer_form():
    """The plain version against the integer form written out: each
    request's padded taps hold its own zero point, a = sum(q * w) -
    zp * colsum in int64, then float32(a) * (scale * w_scale) + bias."""
    rng = np.random.default_rng(3)
    n, h, w, ci, oc, kh, kw = 3, 6, 7, 5, 4, 3, 3
    pads = ((1, 0), (2, 1))
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wk = rng.integers(-127, 128, (kh * kw * ci, oc), dtype=np.int8)
    colsum = wk.astype(np.int64).sum(0).astype(np.int32)
    ws = rng.uniform(1e-3, 1e-2, oc).astype(np.float32)
    zp = rng.integers(-128, 128, n).astype(np.float32)
    sc = rng.uniform(1e-3, 5e-2, n).astype(np.float32)
    bias = rng.uniform(-1, 1, oc).astype(np.float32)
    T = torch.from_numpy
    for b in (bias, None):
        got = K.qconv2d_hybrid(T(x), T(wk), T(ws), T(colsum), T(zp), T(sc),
                               None if b is None else T(b), kh=kh, kw=kw,
                               padding=pads).numpy()
        (pt, pb), (pl, pr) = pads
        for i in range(n):
            xp = np.full((h + pt + pb, w + pl + pr, ci), int(zp[i]), np.int64)
            xp[pt:pt + h, pl:pl + w] = x[i]
            for y in range(got.shape[1]):
                for c in range(got.shape[2]):
                    a = (xp[y:y + kh, c:c + kw].reshape(-1)
                         @ wk.astype(np.int64)) - int(zp[i]) * colsum
                    v = a.astype(np.float32) * (sc[i] * ws)
                    if b is not None:
                        v = v + b
                    np.testing.assert_array_equal(got[i, y, c], v)


def test_tf32_rule_and_mesh_placement():
    """The float TRANSPOSE_CONV is a cuDNN conv under the TF32 rule; the
    hybrid one runs B2 and takes no flag; neither is split across a
    mesh's devices (they run whole on a row's lead device)."""
    for name, flag in ((FLOAT, L.TF32_CONV), (DYNRANGE, None)):
        g = _graph(name)
        op = next(o for o in g.ops if o.opname == "TRANSPOSE_CONV")
        assert L.tf32_flag(g, op) == flag
        assert L.output_channels(g, op) is None
