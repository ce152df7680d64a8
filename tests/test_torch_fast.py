"""Fast numerics (RuntimeConfig.numerics == "fast") in the PyTorch port,
on the CPU, held to band_tpu's fast path byte for byte (tolerance 0):

- quant.requantize_fast against band_tpu's, on random int32
  accumulators with ties and |acc| > 2^24;
- qmatmul_fast's plain version against band_tpu's Pallas ``qmatmul``
  (interpret mode) and its numpy oracle ``qmatmul_reference``;
- every fast CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED and ADD of the
  four CNNs, and one-op graphs with strides, dilation, depth multiplier
  and uint8 weights, against band_tpu's fast programs
  (``build_program(..., exact=False, conv_mode="f32_split")``, as
  tests/test_fast_numerics.py builds them); each through its fast kernel;
- the MEAN-free segments of the models, through the fast goldens
  (tests/gen_torch_fast_goldens.py), per request and as a stacked batch;
- the prepared ``mult`` and bias, carried across by ``params_from_jax``;
- the engine knobs: config, per-model override, and serving.

Tolerance is 0 throughout: the float32 epilogues round the same in both
packages (one rounded product, no FMA, round half to even).  The only
bound that is not 0 is the reference's own: a fast engine's outputs
within 4 quant units of the exact engine's (tests/test_fast_numerics.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import band_tpu as jb
import band_tpu.ir.graph as JG
import band_tpu.tflite.schema as JS
import band_tpu_torch as tb
import band_tpu_torch.ir.graph as TG
import band_tpu_torch.tflite.schema as TS
from band_tpu.backend.program import build_program as jbuild
from band_tpu.ops import quant as JQ
from band_tpu.ops.pallas.qmatmul import qmatmul as pallas_qmatmul
from band_tpu.ops.pallas.qmatmul import qmatmul_reference
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ops import kernels as K
from band_tpu_torch.ops import lowerings as L
from band_tpu_torch.ops import quant as TQ
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests import gen_torch_fast_goldens as FG
from tests.gen_torch_goldens import GOLDENS_PATH, golden_inputs
from tests.test_torch_kernels import CONV_CASES, DW_CASES, _graph

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CNNS = ["mobilenet_v2_int8", "effnetlite_int8", "resnetish_int8", "fc_int8"]
FAST_OPS = ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED", "ADD", "SUB",
            "MUL")
FAST_KERNELS = ("qmatmul_fast", "qconv2d_fast", "qdwconv2d_fast")
EXACT_KERNELS = ("qmatmul_exact", "qconv2d_exact", "qdwconv2d_exact")
QUANT_ACT = os.path.join(DATA, "quant_act_int8.tflite")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


# --------------------------------------------------------------------------
# requantize_fast
# --------------------------------------------------------------------------

def _accumulators(rng, n):
    """int32 accumulators: spread values, exact ties for mult 0.5 and
    0.25 (odd values, and values 2 mod 4), and |acc| above 2^24, where
    the conversion to float32 itself rounds."""
    parts = [
        rng.integers(-2**20, 2**20, n),
        2 * rng.integers(-2**19, 2**19, n) + 1,
        4 * rng.integers(-2**18, 2**18, n) + 2,
        rng.integers(2**24, 2**30, n) * rng.choice([-1, 1], n),
    ]
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("out_dtype,out_zp", [(np.int8, -3), (np.uint8, 128)])
def test_requantize_fast_matches_band_tpu(per_channel, out_dtype, out_zp):
    rng = np.random.default_rng(20)
    acc = _accumulators(rng, 50_000).reshape(-1, 8)
    if per_channel:
        mult = np.array([0.5, 0.25, 2.0**-20, 1.5e-7, 3.1e-5, 0.0123, 1.0,
                         7.7e-9], np.float32)
    else:
        mult = np.array([0.5], np.float32)
    info = np.iinfo(out_dtype)
    want = np.asarray(jax.jit(
        lambda a, m: JQ.requantize_fast(a, m, out_zp, int(info.min),
                                        int(info.max), out_dtype))(acc, mult))
    got = TQ.requantize_fast(_t(acc), _t(mult), out_zp, int(info.min),
                             int(info.max), out_dtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a scalar multiplier gives what a one-entry tensor gives
    scalar = TQ.requantize_fast(_t(acc), float(mult[0]), out_zp,
                                int(info.min), int(info.max), out_dtype)
    one = TQ.requantize_fast(_t(acc), _t(mult[:1]), out_zp, int(info.min),
                             int(info.max), out_dtype)
    assert torch.equal(scalar, one)
    # ties went to even, and the clamp was reached
    assert (np.abs(got.astype(np.int64) - out_zp) < 3).any()
    assert (got == info.max).any() and (got == info.min).any()


def test_requantize_fast_saturates_beyond_int32():
    """Products beyond int32 clamp by their sign (the kernel's
    __float2int_rn saturates); no TFLite multiplier reaches them."""
    acc = _t(np.array([2**31 - 1, -2**31, 5, -5], np.int32))
    out = TQ.requantize_fast(acc, 1000.0, 10, -128, 127, np.int8)
    assert out.tolist() == [127, -128, 127, -128]


# --------------------------------------------------------------------------
# qmatmul_fast's plain version vs the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

def _fast_epilogue(rng, n, k, per_channel=True, ties=False):
    """bias [N] int32 and mult float32 mapping the accumulator's spread to
    ~30 units; ``ties``: mult 0.5 with odd accumulators' products."""
    if ties:
        mult = np.full(n if per_channel else 1, 0.5, np.float32)
    else:
        mult = (30.0 / (np.sqrt(k) * 73.0 * 73.0)
                * rng.uniform(0.5, 2.0, n if per_channel else 1)
                ).astype(np.float32)
    bias = rng.integers(-20000, 20000, n).astype(np.int32)
    return bias, mult


PALLAS_CASES = [
    # (m, k, n, per_channel, ties, big): shapes that tile by 256 (or fit
    # one tile), as the Pallas kernel requires
    (64, 40, 24, True, False, False),
    (256, 96, 256, False, False, False),
    (512, 40, 256, True, True, False),
    (256, 1536, 128, True, False, True),
]


@pytest.mark.parametrize("m,k,n,per_channel,ties,big", PALLAS_CASES)
def test_qmatmul_fast_plain_matches_pallas(m, k, n, per_channel, ties, big):
    rng = np.random.default_rng(21)
    lo = 100 if big else -128  # big: |acc| > 2^24 on every output
    a = rng.integers(lo, 128, (m, k)).astype(np.int8)
    b = rng.integers(lo, 128, (k, n)).astype(np.int8)
    bias, mult = _fast_epilogue(rng, n, k, per_channel, ties)
    if big:
        mult = (mult * 1e-3).astype(np.float32)
        assert (np.abs(a.astype(np.int64) @ b.astype(np.int64)) > 2**24).all()
    mult_n = np.broadcast_to(mult, (n,)).astype(np.float32)
    want = np.asarray(pallas_qmatmul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
        jnp.asarray(mult_n), out_zp=-3))
    got = K.qmatmul_fast(_t(a), _t(b), _t(bias), _t(mult), out_zp=-3).numpy()
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, qmatmul_reference(a, b, bias, mult_n, out_zp=-3))


@pytest.mark.parametrize("m,k,n", [(33, 27, 10), (200, 96, 72), (1, 1280, 1000)])
def test_qmatmul_fast_plain_matches_reference_on_ragged_shapes(m, k, n):
    """Shapes the Pallas kernel does not tile: its numpy oracle."""
    rng = np.random.default_rng(22)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    bias, mult = _fast_epilogue(rng, n, k)
    got = K.qmatmul_fast(_t(a), _t(b), _t(bias), _t(mult), out_zp=5,
                         qmin=-100, qmax=100).numpy()
    np.testing.assert_array_equal(
        got, qmatmul_reference(a, b, bias, mult, out_zp=5, qmin=-100,
                               qmax=100))


# --------------------------------------------------------------------------
# every fast op of the CNNs, and one-op graphs, against band_tpu
# --------------------------------------------------------------------------

def _record_kernel_calls():
    """Wrap the lowerings' kernel globals; returns (calls, restore)."""
    calls = []
    saved = {n: getattr(L, n) for n in FAST_KERNELS + EXACT_KERNELS}

    def wrap(name, f):
        def g(*args, **kw):
            calls.append(name)
            return f(*args, **kw)
        return g

    for n, f in saved.items():
        setattr(L, n, wrap(n, f))

    def restore():
        for n, f in saved.items():
            setattr(L, n, f)
    return calls, restore


def _random_inputs(rng, prog):
    ins = []
    for shape, dtype in prog.input_specs:
        info = np.iinfo(dtype)
        ins.append(rng.integers(info.min, info.max + 1,
                                [max(s, 1) for s in shape]).astype(dtype))
    return ins


def _port_fast(tg, ops, ins):
    """(outputs, kernels called) of the port's fast program of ``ops``."""
    tprog = tbuild(tg, ops, exact=False)
    calls, restore = _record_kernel_calls()
    try:
        touts = tprog.make_fn()(params_from_jax(tprog.params),
                                [_t(x) for x in ins])
    finally:
        restore()
    return [o.numpy() for o in touts], calls


def _band_tpu_fast(jg, ops, ins):
    jprog = jbuild(jg, ops, exact=False, conv_mode="f32_split")
    return [np.asarray(o)
            for o in jax.jit(jprog.make_fn())(jprog.params, list(ins))]


@pytest.mark.parametrize("name", CNNS)
def test_every_fast_op_matches_band_tpu(name):
    tg, jg = tparse(_path(name)), jparse(_path(name))
    checked = 0
    for op in tg.ops:
        if op.opname not in FAST_OPS:
            continue
        rng = np.random.default_rng(1000 + op.index)
        ins = _random_inputs(rng, tbuild(tg, [op.index]))
        touts, calls = _port_fast(tg, [op.index], ins)
        jouts = _band_tpu_fast(jg, [op.index], ins)
        for a, b in zip(touts, jouts):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"op {op.index}")
        # the convs and the FC went through a fast kernel, none exact
        if op.opname != "ADD":
            assert len(calls) == 1 and calls[0] in FAST_KERNELS, calls
        checked += 1
    assert checked >= 3


def _fast_one_op(rng, opname, options, x_shape, x_dtype, w, w_scales, w_zps,
                 qdim, out_shape, kernel, batch=3):
    n_out = w.shape[-1] if opname == "DEPTHWISE_CONV_2D" else w.shape[0]
    bias = rng.integers(-3000, 3000, n_out).astype(np.int32)
    gj, gt = (_graph(G, S, opname, options, x_shape, x_dtype, w, w_scales,
                     w_zps, qdim, bias, out_shape, x_dtype)
              for G, S in ((JG, JS), (TG, TS)))
    info = np.iinfo(x_dtype)
    xs = [rng.integers(info.min, info.max + 1, x_shape).astype(x_dtype)
          for _ in range(batch)]
    want = [_band_tpu_fast(gj, [0], [x])[0] for x in xs]
    # a stacked window of requests gives the requests' outputs
    got, calls = _port_fast(gt, [0], [np.concatenate(xs)])
    np.testing.assert_array_equal(got[0], np.concatenate(want))
    assert calls == [kernel]
    pt = tbuild(gt, [0], exact=False)
    pj = jbuild(gj, [0], exact=False, conv_mode="f32_split")
    for key in ("w", "bias", "mult"):
        np.testing.assert_array_equal(pt.params[f"op0/{key}"],
                                      pj.params[f"op0/{key}"])
        assert pt.params[f"op0/{key}"].dtype == pj.params[f"op0/{key}"].dtype


@pytest.mark.parametrize("stride,dil,padding,kh,kw,ci,oc,x_dtype",
                         CONV_CASES)
def test_fast_conv2d_lowering_matches_band_tpu(stride, dil, padding, kh, kw,
                                               ci, oc, x_dtype):
    rng = np.random.default_rng(23)
    opts = dict(padding=padding, stride_h=stride[0], stride_w=stride[1],
                dilation_h=dil[0], dilation_w=dil[1], activation="RELU")
    h = w = 11
    ekh, ekw = (kh - 1) * dil[0] + 1, (kw - 1) * dil[1] + 1
    if padding == "SAME":
        oh, ow = -(-h // stride[0]), -(-w // stride[1])
    else:
        oh, ow = (h - ekh) // stride[0] + 1, (w - ekw) // stride[1] + 1
    if x_dtype == np.uint8:
        wt = rng.integers(0, 256, (oc, kh, kw, ci)).astype(np.uint8)
        scales, zps = [0.02], [117]
    else:
        wt = rng.integers(-127, 128, (oc, kh, kw, ci)).astype(np.int8)
        scales, zps = list(rng.uniform(0.005, 0.03, oc)), [0] * oc
    pointwise = (kh, kw, stride, padding) == (1, 1, (1, 1), "VALID")
    _fast_one_op(rng, "CONV_2D", opts, (1, h, w, ci), x_dtype, wt, scales,
                 zps, 0, (1, oh, ow, oc),
                 "qmatmul_fast" if pointwise else "qconv2d_fast")


@pytest.mark.parametrize("stride,dil,padding,c,mult,x_dtype", DW_CASES)
def test_fast_depthwise_lowering_matches_band_tpu(stride, dil, padding, c,
                                                  mult, x_dtype):
    rng = np.random.default_rng(24)
    kh = kw = 3
    opts = dict(padding=padding, stride_h=stride[0], stride_w=stride[1],
                dilation_h=dil[0], dilation_w=dil[1], depth_multiplier=mult,
                activation="RELU6")
    h, w = 10, 9
    ek = (kh - 1) * dil[0] + 1
    if padding == "SAME":
        oh, ow = -(-h // stride[0]), -(-w // stride[1])
    else:
        oh, ow = (h - ek) // stride[0] + 1, (w - ek) // stride[1] + 1
    co = c * mult
    if x_dtype == np.uint8:
        wt = rng.integers(0, 256, (1, kh, kw, co)).astype(np.uint8)
        scales, zps = [0.02], [121]
    else:
        wt = rng.integers(-127, 128, (1, kh, kw, co)).astype(np.int8)
        scales, zps = list(rng.uniform(0.005, 0.03, co)), [0] * co
    _fast_one_op(rng, "DEPTHWISE_CONV_2D", opts, (1, h, w, c), x_dtype, wt,
                 scales, zps, 3, (1, oh, ow, co), "qdwconv2d_fast")


@pytest.mark.parametrize("x_dtype", [np.int8, np.uint8])
def test_fast_fully_connected_lowering_matches_band_tpu(x_dtype):
    """uint8 models carry a weight zero point: B4 subtracts w_zp * rowsum
    before the bias, as band_tpu's fast FC does."""
    rng = np.random.default_rng(25)
    k, n = 40, 12
    if x_dtype == np.uint8:
        wt = rng.integers(0, 256, (n, k)).astype(np.uint8)
        scales, zps = [0.02], [125]
    else:
        wt = rng.integers(-127, 128, (n, k)).astype(np.int8)
        scales, zps = list(rng.uniform(0.005, 0.03, n)), [0] * n
    _fast_one_op(rng, "FULLY_CONNECTED", dict(activation="NONE"), (1, k),
                 x_dtype, wt, scales, zps, 0, (1, n), "qmatmul_fast",
                 batch=4)


# --------------------------------------------------------------------------
# whole models: the fast goldens
# --------------------------------------------------------------------------

def test_fast_goldens_regenerate_unchanged():
    """Regenerating tests/data/torch_fast_goldens.npz gives the stored
    file, array for array; the generator asserts on the way that the
    port's fast program equals band_tpu's on every MEAN-free segment of
    every golden request."""
    pytest.importorskip("tensorflow")
    stored = np.load(FG.FAST_GOLDENS_PATH)
    fresh = FG.compute()
    assert sorted(fresh) == sorted(stored.files)
    for key, v in fresh.items():
        np.testing.assert_array_equal(v, stored[key], err_msg=key)
        assert v.dtype == stored[key].dtype, key


@pytest.mark.parametrize("name", CNNS + ["quant_act_int8"])
def test_stacked_fast_batch_matches_fast_goldens(name):
    z = np.load(FG.FAST_GOLDENS_PATH)
    g = tparse(_path(name))
    td = g.tensor(g.inputs[0])
    xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype)
    want = [z[f"{name}/fast_output{j}"] for j in range(len(g.outputs))]
    ex = ModelExecutor(0, g, 0, torch.device("cpu"), exact=False)
    assert not ex.exact
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    order = [ex.output_ids(key).index(t) for t in g.outputs]
    for i, outs in enumerate(ex.execute_batched(key, [[x] for x in xs[:4]])):
        for j, pos in enumerate(order):
            np.testing.assert_array_equal(outs[pos].numpy(), want[j][i])
    single = ex.execute(key, [xs[5]])
    for j, pos in enumerate(order):
        np.testing.assert_array_equal(single[pos].numpy(), want[j][5])


@pytest.mark.parametrize("name", CNNS + ["quant_act_int8"])
def test_prepared_fast_params_match_band_tpu(name):
    """The prepared keys shared with band_tpu's fast prepare (weights,
    folded bias, float32 mult, the ADD/SUB/MUL rescales) are equal, and
    band_tpu's prepared params carried across give the port's outputs."""
    tg, jg = tparse(_path(name)), jparse(_path(name))
    ops = range(len(tg.ops))
    tprog = tbuild(tg, ops, exact=False)
    jprog = jbuild(jg, ops, exact=False, conv_mode="f32_split")
    # MEAN follows TFLite, not band_tpu (ROADMAP C1): its keys differ
    means = tuple(f"op{op.index}/" for op in tg.ops if op.opname == "MEAN")
    checked = 0
    for key, v in tprog.params.items():
        if key.startswith(means):
            continue
        np.testing.assert_array_equal(v, jprog.params[key], err_msg=key)
        assert v.dtype == jprog.params[key].dtype, key
        checked += key.endswith("/mult")
    assert not any(k.endswith(("/qm", "/shift")) for k in tprog.params
                   if not k.startswith(means))
    for key, v in tprog.meta.items():
        if not key.startswith(means):
            assert v == jprog.meta[key], key
    assert checked == sum(op.opname in FAST_OPS[:3] for op in tg.ops)
    x = golden_inputs(7, tg.tensor(tg.inputs[0]).shape,
                      tg.tensor(tg.inputs[0]).dtype, 1)[0]
    fn = tprog.make_fn()
    outs = [fn(params_from_jax(p), [_t(x)])
            for p in (tprog.params,
                      {k: v for k, v in jprog.params.items()
                       if k in tprog.params})]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the engine: config knob, per-model override, serving
# --------------------------------------------------------------------------

def _cpu_config(pkg, numerics="exact", max_batch=1):
    return (pkg.RuntimeConfigBuilder()
            .add_scheduler(pkg.SchedulerType.FIXED_WORKER)
            .add_worker(pkg.WorkerSpec(device=pkg.DeviceFlag.CPU,
                                       device_ids=(0,), max_batch=max_batch))
            .numerics(numerics)
            .profile_warmups(0)
            .profile_runs(1)
            .build())


def test_config_numerics_knob():
    cfg = tb.RuntimeConfigBuilder().numerics("fast").add_worker(
        tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,))
    ).build()
    assert cfg.numerics == "fast"
    from band_tpu_torch.config import config_from_dict, config_hash

    d = {"schedulers": ["fixed_worker"], "workers": ["cpu"],
         "numerics": "FAST"}
    cfg2 = config_from_dict(d)
    assert cfg2.numerics == "fast"
    # fast/exact profiles must not share a persisted-profile key
    d["numerics"] = "exact"
    assert config_hash(cfg2) != config_hash(config_from_dict(d))
    with pytest.raises(tb.ConfigError):
        tb.RuntimeConfigBuilder().numerics("approximate").add_worker(
            tb.WorkerSpec(device=tb.DeviceFlag.CPU, device_ids=(0,))
        ).build()
    # a fast config from JSON serves (nothing refuses fast numerics)
    eng = tb.Engine.create(cfg2)
    try:
        mid = eng.register_model(tb.Model.from_path(_path("fc_int8")))
        assert not eng.model_record(mid).executors[0].exact
    finally:
        eng.shutdown()


def test_per_model_numerics_override():
    """register_model(numerics=...) overrides the engine default per
    model: exact and fast models side by side on one worker, each giving
    its own goldens."""
    z, zf = np.load(GOLDENS_PATH), np.load(FG.FAST_GOLDENS_PATH)
    eng = tb.Engine.create(_cpu_config(tb, max_batch=4))
    try:
        mid_exact = eng.register_model(tb.Model.from_path(QUANT_ACT))
        mid_fast = eng.register_model(tb.Model.from_path(QUANT_ACT),
                                      numerics="fast")
        fc_fast = eng.register_model(tb.Model.from_path(_path("fc_int8")),
                                     numerics="fast")
        fc_exact = eng.register_model(tb.Model.from_path(_path("fc_int8")),
                                      numerics="exact")
        ex_e = eng.model_record(mid_exact).executors[0]
        ex_f = eng.model_record(mid_fast).executors[0]
        assert ex_e.exact and not ex_f.exact
        with pytest.raises(tb.ConfigError):
            eng.register_model(tb.Model.from_path(QUANT_ACT),
                               numerics="sloppy")
        g = eng.model_record(mid_fast).model.graph
        td = g.tensor(g.inputs[0])
        xs = golden_inputs(int(zf["quant_act_int8/seed"]), td.shape,
                           td.dtype)
        gf = eng.model_record(fc_fast).model.graph
        tdf = gf.tensor(gf.inputs[0])
        fxs = golden_inputs(int(z["fc_int8/seed"]), tdf.shape, tdf.dtype)
        ids = []
        for i in range(4):  # interleaved
            ids += [(mid_exact, i, eng.request_async(mid_exact, [xs[i]])),
                    (mid_fast, i, eng.request_async(mid_fast, [xs[i]])),
                    (fc_fast, i, eng.request_async(fc_fast, [fxs[i]])),
                    (fc_exact, i, eng.request_async(fc_exact, [fxs[i]]))]
        for mid, i, j in ids:
            outs = eng.wait(j)
            for o, key in enumerate(
                    {mid_exact: ["quant_act_int8/tflite_output%d"] * 4,
                     mid_fast: ["quant_act_int8/fast_output%d"] * 4,
                     fc_fast: ["fc_int8/fast_output%d"],
                     fc_exact: [None]}[mid]):
                want = (z["fc_int8/output"][i] if key is None
                        else zf[key % o][i])
                np.testing.assert_array_equal(outs[o], want)
    finally:
        eng.shutdown()


def test_engine_serves_fast_numerics():
    """End to end on quant_act_int8: the fast engine's outputs within 4
    quant units of the exact engine's (the reference's bound), and byte
    for byte band_tpu's fast engine's."""
    rng = np.random.default_rng(7)
    g = tparse(QUANT_ACT)
    td = g.tensor(g.inputs[0])
    info = np.iinfo(td.dtype)
    x = rng.integers(info.min, info.max + 1,
                     [max(s, 1) for s in td.shape]).astype(td.dtype)
    outs = {}
    for pkg in (tb, jb):
        for mode in ("exact", "fast"):
            eng = pkg.Engine.create(_cpu_config(pkg, mode))
            try:
                mid = eng.register_model(pkg.Model.from_path(QUANT_ACT))
                outs[pkg.__name__, mode] = eng.request_sync(mid, [x],
                                                            timeout=120)
            finally:
                eng.shutdown()
    for a, b in zip(outs["band_tpu_torch", "exact"],
                    outs["band_tpu_torch", "fast"]):
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert diff.max() <= 4, diff.max()
    for a, b in zip(outs["band_tpu_torch", "fast"], outs["band_tpu", "fast"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
