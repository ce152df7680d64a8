"""The plain PyTorch versions of the port's kernels (what a kernel
wrapper runs on a CPU tensor) against band_tpu: the Pallas kernels run
in interpret mode on the CPU, and band_tpu's CONV_2D, DEPTHWISE_CONV_2D
and FULLY_CONNECTED lowerings for the geometries the Pallas kernels do
not take (strides, dilation, depth multiplier, uint8 models).  Same
numpy inputs to both; every comparison is byte-equal (tolerance 0).
The exact ADD/SUB is held to its int64 chain (qaddsub_plain) and to
its kernel's arithmetic replayed in numpy, with the lowering's route
between the two.

The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py holds them to the plain versions there."""

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
from band_tpu.ops.pallas.qconv import qconv2d_exact as pallas_qconv
from band_tpu.ops.pallas.qdwconv import qdwconv2d_exact as pallas_qdwconv
from band_tpu.ops.pallas.qmatmul import qmatmul_exact as pallas_qmatmul
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ops import kernels as K
from band_tpu_torch.ops import lowerings as L
from band_tpu_torch.tracing import counters

ROUNDINGS = ["single", "double", "ruy"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _epilogue(rng, n, k):
    """bias, qm, shift (int32) mapping the accumulator's spread to ~30."""
    m = 30.0 / (np.sqrt(k) * 73.0 * 73.0) * rng.uniform(0.5, 2.0, n)
    qm, sh = JQ.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, n).astype(np.int32)
    return bias, qm, sh


def _out_args(out_dtype):
    if out_dtype == np.uint8:
        return dict(out_zp=128, qmin=0, qmax=255)
    return dict(out_zp=-3, qmin=-128, qmax=127)


# --------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("w_zp,out_dtype", [(0, np.int8), (5, np.uint8)])
def test_qmatmul_plain_matches_pallas(rounding, w_zp, out_dtype):
    rng = np.random.default_rng(10)
    m, k, n = 64, 40, 24
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    bias, qm, sh = _epilogue(rng, n, k)
    kw = dict(_out_args(out_dtype), rounding=rounding, w_zp=w_zp)
    want = np.asarray(pallas_qmatmul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias), jnp.asarray(qm),
        jnp.asarray(sh), out_dtype=out_dtype, **kw))
    got = K.qmatmul_exact(_t(a), _t(b), _t(bias), _t(qm), _t(sh),
                          out_dtype=out_dtype, **kw).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kh,kw,ci,oc,w_zp,rounding,out_dtype", [
    (3, 3, 8, 16, 0, "ruy", np.int8),
    (3, 3, 3, 8, -4, "single", np.uint8),
    (5, 3, 4, 12, 2, "double", np.int8),
])
def test_qconv_plain_matches_pallas(kh, kw, ci, oc, w_zp, rounding,
                                    out_dtype):
    """Stride 1 (what the Pallas kernel takes), on an x_zp-padded input;
    the plain version also gets the unpadded input and the padding."""
    rng = np.random.default_rng(11)
    n, h, w, x_zp = 2, 8, 8, -9
    ph, pw = (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)
    x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    x_pad = np.pad(x, ((0, 0), ph, pw, (0, 0)), constant_values=x_zp)
    wk = rng.integers(-128, 128, (kh * kw * ci, oc)).astype(np.int8)
    bias, qm, sh = _epilogue(rng, oc, kh * kw * ci)
    args = dict(_out_args(out_dtype), rounding=rounding, w_zp=w_zp)
    want = np.asarray(pallas_qconv(
        jnp.asarray(x_pad), jnp.asarray(wk), jnp.asarray(bias),
        jnp.asarray(qm), jnp.asarray(sh), kh=kh, kw=kw, out_dtype=out_dtype,
        tile_h=h, **args))
    epi = (_t(bias), _t(qm), _t(sh))
    got_padded = K.qconv2d_exact(_t(x_pad), _t(wk), *epi, kh=kh, kw=kw,
                                 out_dtype=out_dtype, **args).numpy()
    got = K.qconv2d_exact(_t(x), _t(wk), *epi, kh=kh, kw=kw,
                          padding=(ph, pw), x_zp=x_zp, out_dtype=out_dtype,
                          **args).numpy()
    np.testing.assert_array_equal(got_padded, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride,w_zp,rounding,out_dtype", [
    (1, 0, "ruy", np.int8),
    (2, 3, "double", np.uint8),
    (2, 0, "single", np.int8),
])
def test_qdwconv_plain_matches_pallas(stride, w_zp, rounding, out_dtype):
    rng = np.random.default_rng(12)
    n, c, kh, kw, oh, ow, x_zp = 2, 16, 3, 3, 6, 5, 7
    hp, wp = (oh - 1) * stride + kh, (ow - 1) * stride + kw
    x_pad = rng.integers(-128, 128, (n, hp, wp, c)).astype(np.int8)
    wk = rng.integers(-128, 128, (kh * kw, c)).astype(np.int8)
    bias, qm, sh = _epilogue(rng, c, kh * kw)
    args = dict(_out_args(out_dtype), rounding=rounding, w_zp=w_zp)
    want = np.asarray(pallas_qdwconv(
        jnp.asarray(x_pad), jnp.asarray(wk.astype(np.int32)),
        jnp.asarray(bias), jnp.asarray(qm), jnp.asarray(sh), kh=kh, kw=kw,
        sh=stride, sw=stride, out_dtype=out_dtype, tile_h=oh, **args))
    got = K.qdwconv2d_exact(_t(x_pad), _t(wk), _t(bias), _t(qm), _t(sh),
                            kh=kh, kw=kw, stride=(stride, stride),
                            out_dtype=out_dtype, **args).numpy()
    np.testing.assert_array_equal(got, want)
    # the same output from the unpadded interior and explicit padding
    inner = x_pad[:, 1:-1, 1:-1, :]
    if stride == 1:
        x_pad2 = np.pad(inner, ((0, 0), (1, 1), (1, 1), (0, 0)),
                        constant_values=x_zp)
        want2 = K.qdwconv2d_exact(_t(x_pad2), _t(wk), _t(bias), _t(qm),
                                  _t(sh), kh=kh, kw=kw, out_dtype=out_dtype,
                                  **args).numpy()
        got2 = K.qdwconv2d_exact(_t(inner), _t(wk), _t(bias), _t(qm),
                                 _t(sh), kh=kh, kw=kw,
                                 padding=((1, 1), (1, 1)), x_zp=x_zp,
                                 out_dtype=out_dtype, **args).numpy()
        np.testing.assert_array_equal(got2, want2)


# --------------------------------------------------------------------------
# one-op graphs through both packages' lowerings (strides, dilation,
# depth multiplier, uint8 weights)
# --------------------------------------------------------------------------

def _graph(G, S, opname, options, x_shape, x_dtype, w, w_scales, w_zps,
           qdim, bias, out_shape, out_dtype):
    tt = {np.dtype(np.int8): S.TensorType.INT8,
          np.dtype(np.uint8): S.TensorType.UINT8,
          np.dtype(np.int32): S.TensorType.INT32}

    def qp(scale, zp, dim=0):
        return G.QuantParams(np.asarray(scale, np.float32),
                             np.asarray(zp, np.int32), dim)

    x_zp = 3 if x_dtype == np.int8 else 131
    out_zp = -5 if out_dtype == np.int8 else 120
    tensors = [
        G.TensorDef(0, "x", tuple(x_shape), tt[np.dtype(x_dtype)],
                    qp([0.05], [x_zp])),
        G.TensorDef(1, "w", tuple(w.shape), tt[w.dtype],
                    qp(w_scales, w_zps, qdim), data=w),
        G.TensorDef(2, "b", tuple(bias.shape), S.TensorType.INT32,
                    qp(0.05 * np.asarray(w_scales), np.zeros(len(w_scales))),
                    data=bias),
        G.TensorDef(3, "y", tuple(out_shape), tt[np.dtype(out_dtype)],
                    qp([0.11], [out_zp])),
    ]
    op = G.OpNode(0, opname, [0, 1, 2], [3], dict(options))
    return G.Graph("one_op", tensors, [op], [0], [3])


def _both(rng, opname, options, x_shape, x_dtype, w, w_scales, w_zps, qdim,
          out_shape, batch=1):
    # output channels: OHWI conv and [out, in] FC weights lead with them
    n_out = w.shape[-1] if opname == "DEPTHWISE_CONV_2D" else w.shape[0]
    bias = rng.integers(-3000, 3000, n_out).astype(np.int32)
    gj = _graph(JG, JS, opname, options, x_shape, x_dtype, w, w_scales,
                w_zps, qdim, bias, out_shape, x_dtype)
    gt = _graph(TG, TS, opname, options, x_shape, x_dtype, w, w_scales,
                w_zps, qdim, bias, out_shape, x_dtype)
    info = np.iinfo(x_dtype)
    xs = [rng.integers(info.min, info.max + 1, x_shape).astype(x_dtype)
          for _ in range(batch)]
    pj = jbuild(gj, [0], exact=True, conv_mode="f32_split")
    fj = jax.jit(pj.make_fn())
    want = [np.asarray(fj(pj.params, [x])[0]) for x in xs]
    pt = tbuild(gt, [0])
    # the shared prepared keys equal band_tpu's
    for key in ("w", "bias", "qm", "shift"):
        np.testing.assert_array_equal(pt.params[f"op0/{key}"],
                                      pj.params[f"op0/{key}"])
    for key in ("x_zp", "w_zp", "qmin", "qmax", "out_zp", "rounding"):
        assert pt.meta[f"op0/{key}"] == pj.meta[f"op0/{key}"], key
    fn = pt.make_fn()
    # band_tpu's prepared weights, carried across, give the same outputs
    # as the port's own
    for params in (params_from_jax(pt.params), params_from_jax(pj.params)):
        got = fn(params, [_t(np.concatenate(xs))])[0].numpy()
        np.testing.assert_array_equal(got, np.concatenate(want))


CONV_CASES = [
    # (stride, dilation, padding, kh, kw, ci, oc, x_dtype)
    ((2, 2), (1, 1), "SAME", 3, 3, 3, 8, np.int8),
    ((2, 1), (1, 1), "VALID", 3, 2, 5, 6, np.int8),
    ((1, 1), (2, 2), "SAME", 3, 3, 4, 8, np.int8),
    ((2, 2), (1, 1), "SAME", 3, 3, 8, 4, np.uint8),
    ((1, 1), (1, 1), "VALID", 1, 1, 16, 8, np.int8),
]


@pytest.mark.parametrize("stride,dil,padding,kh,kw,ci,oc,x_dtype",
                         CONV_CASES)
def test_conv2d_lowering_matches_band_tpu(stride, dil, padding, kh, kw, ci,
                                          oc, x_dtype):
    rng = np.random.default_rng(13)
    opts = dict(padding=padding, stride_h=stride[0], stride_w=stride[1],
                dilation_h=dil[0], dilation_w=dil[1], activation="RELU")
    h = w = 11
    ekh, ekw = (kh - 1) * dil[0] + 1, (kw - 1) * dil[1] + 1
    if padding == "SAME":
        oh, ow = -(-h // stride[0]), -(-w // stride[1])
    else:
        oh, ow = (h - ekh) // stride[0] + 1, (w - ekw) // stride[1] + 1
    if x_dtype == np.uint8:
        # uint8 models: per-tensor weights with a nonzero zero point
        wt = rng.integers(0, 256, (oc, kh, kw, ci)).astype(np.uint8)
        scales, zps, qdim = [0.02], [117], 0
    else:
        wt = rng.integers(-127, 128, (oc, kh, kw, ci)).astype(np.int8)
        scales, zps, qdim = list(rng.uniform(0.005, 0.03, oc)), [0] * oc, 0
    _both(rng, "CONV_2D", opts, (1, h, w, ci), x_dtype, wt, scales, zps,
          qdim, (1, oh, ow, oc), batch=3)


DW_CASES = [
    # (stride, dilation, padding, c, mult, x_dtype)
    ((2, 2), (1, 1), "SAME", 8, 1, np.int8),
    ((1, 1), (2, 2), "SAME", 6, 1, np.int8),
    ((2, 1), (1, 1), "VALID", 4, 2, np.int8),
    ((1, 1), (1, 1), "SAME", 5, 1, np.uint8),
]


@pytest.mark.parametrize("stride,dil,padding,c,mult,x_dtype", DW_CASES)
def test_depthwise_lowering_matches_band_tpu(stride, dil, padding, c, mult,
                                             x_dtype):
    rng = np.random.default_rng(14)
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
    _both(rng, "DEPTHWISE_CONV_2D", opts, (1, h, w, c), x_dtype, wt, scales,
          zps, 3, (1, oh, ow, co), batch=3)


@pytest.mark.parametrize("x_dtype", [np.int8, np.uint8])
def test_fully_connected_lowering_matches_band_tpu(x_dtype):
    rng = np.random.default_rng(15)
    k, n = 40, 12
    if x_dtype == np.uint8:
        wt = rng.integers(0, 256, (n, k)).astype(np.uint8)
        scales, zps = [0.02], [125]
    else:
        wt = rng.integers(-127, 128, (n, k)).astype(np.int8)
        scales, zps = list(rng.uniform(0.005, 0.03, n)), [0] * n
    _both(rng, "FULLY_CONNECTED", dict(activation="NONE"), (1, k), x_dtype,
          wt, scales, zps, 0, (1, n), batch=4)


# --------------------------------------------------------------------------
# exact ADD/SUB: the lowering's route to qaddsub, and the kernel's
# arithmetic (csrc/qaddsub.cu) replayed in numpy
# --------------------------------------------------------------------------

def _addsub_graph(opname, dtype, act, s1, s2, shape2=None, const2=None):
    """A one-op ADD/SUB graph over [1, 256, 256, 1] int8/uint8 inputs;
    the second input of ``shape2`` (broadcast) or the constant
    ``const2``."""
    tt = TS.TensorType.UINT8 if dtype == np.uint8 else TS.TensorType.INT8
    off = 128 if dtype == np.uint8 else 0

    def qp(scale, zp):
        return TG.QuantParams(np.asarray([scale], np.float32),
                              np.asarray([zp + off], np.int32))

    shape = (1, 256, 256, 1)
    tensors = [
        TG.TensorDef(0, "x1", shape, tt, qp(s1, 3)),
        TG.TensorDef(1, "x2", tuple(shape2 or shape), tt, qp(s2, -7),
                     data=const2),
        TG.TensorDef(2, "y", shape, tt, qp(max(s1, s2) * 1.7, 5)),
    ]
    op = TG.OpNode(0, opname, [0, 1], [2], dict(activation=act))
    inputs = [0] if const2 is not None else [0, 1]
    return TG.Graph("addsub", tensors, [op], inputs, [2])


def _addsub_replay(b1, b2, u1, u2, p, sign):
    """csrc/qaddsub.cu's arithmetic (single rounding) in numpy: a table
    of each input's rescaled term by byte, the sum in int64, the output
    MBQM, the clamp to [qmin - zpo, qmax - zpo] and then + zpo, the low
    byte stored."""
    def wrap32(v):
        return v.astype(np.uint64).astype(np.uint32).view(np.int32)

    def mbqm(x, qm, sh):
        t = 31 - sh
        with np.errstate(over="ignore"):
            prod = x.view(np.uint64) * np.uint64(qm) + np.uint64(1 << (t - 1))
        return wrap32(prod.view(np.int64) >> np.int64(t)).astype(np.int64)

    def table(u, zp, qm, sh):
        k = np.arange(256)
        v = k if u else k.astype(np.uint8).view(np.int8)
        return mbqm((v.astype(np.int64) - zp) << p["left_shift"], qm, sh)

    t1 = table(u1, p["zp1"], p["qm1"], p["sh1"])
    t2 = table(u2, p["zp2"], p["qm2"], p["sh2"])
    raw = t1[b1] + sign * t2[b2]
    v = np.clip(mbqm(raw, p["qmo"], p["sho"]), p["qmin"] - p["zpo"],
                p["qmax"] - p["zpo"])
    return ((v + p["zpo"]) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("ratio", [2.0 ** 12, 1.0, 2.0 ** -12])
@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6"])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("opname", ["ADD", "SUB"])
def test_routed_addsub_equals_the_int64_chain(opname, dtype, act, ratio):
    """Every byte pair through a one-op program: the routed lowering
    (qaddsub's plain version on the CPU), the int64 chain called with the
    prepared scalars, and the kernel's arithmetic replayed, byte for
    byte."""
    b1, b2 = (a.ravel().astype(np.uint8)
              for a in np.meshgrid(np.arange(256), np.arange(256)))
    x1, x2 = (_t(b.view(dtype).reshape(1, 256, 256, 1)) for b in (b1, b2))
    prog = tbuild(_addsub_graph(opname, dtype, act, 0.02 * ratio, 0.02), [0])
    before = counters.snapshot()
    got = prog.make_fn()(params_from_jax(prog.params), [x1, x2])[0]
    assert counters.delta(counters.snapshot(), before)["addsub_plain"] == 0
    p = {k: int(prog.meta[f"op0/{k}"]) for k in K.addsub.PARAMS}
    sign = 1 if opname == "ADD" else -1
    want = K.qaddsub_plain(x1, x2, sign=sign, out_dtype=x1.dtype, **p)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    replay = _addsub_replay(b1, b2, dtype == np.uint8, dtype == np.uint8, p,
                            sign)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy().ravel(),
                                  replay)


@pytest.mark.parametrize("form", ["same", "broadcast", "constant"])
def test_addsub_routes_by_shape(monkeypatch, form):
    """In a window of two, same-shape operands take qaddsub; a broadcast or
    a constant operand (its view [1, ...] against the window's [2, ...])
    takes the int64 chain and raises ``addsub_plain`` by one; both give
    the chain's bytes."""
    rng = np.random.default_rng(19)
    batch = 2
    shape2 = (1, 1, 1, 1) if form == "broadcast" else None
    c2 = (rng.integers(-128, 128, (1, 256, 256, 1)).astype(np.int8)
          if form == "constant" else None)
    prog = tbuild(_addsub_graph("ADD", np.int8, "NONE", 0.03, 0.02,
                                shape2=shape2, const2=c2), [0])
    xs = [_t(rng.integers(-128, 128, (batch, 256, 256, 1)).astype(np.int8))]
    if form != "constant":
        xs.append(_t(rng.integers(-128, 128, (batch,) + (
            shape2 or (1, 256, 256, 1))[1:]).astype(np.int8)))
    calls = []

    def record(*args, **kw):
        calls.append(args)
        return K.qaddsub(*args, **kw)

    monkeypatch.setattr(L, "qaddsub", record)
    before = counters.snapshot()
    got = prog.make_fn()(params_from_jax(prog.params), xs)[0]
    moved = counters.delta(counters.snapshot(), before)["addsub_plain"]
    assert (len(calls), moved) == ((1, 0) if form == "same" else (0, 1))
    p = {k: int(prog.meta[f"op0/{k}"]) for k in K.addsub.PARAMS}
    want = K.qaddsub_plain(xs[0], _t(c2) if form == "constant" else xs[1],
                           sign=1, out_dtype=torch.int8, **p)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --------------------------------------------------------------------------
# wrapper contract
# --------------------------------------------------------------------------

# an ADD's prepared scalars (scales 0.03 and 0.02 in, 0.05 out)
_ADD_ARGS = dict(zp1=3, zp2=-7, zpo=5, qm1=1073741824, sh1=0,
                 qm2=1431655765, sh2=-1, qmo=1288490189, sho=-19,
                 left_shift=20, qmin=-128, qmax=127)


def test_wrappers_refuse_bad_operands():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 3), dtype=torch.int8)
    epi = (torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.int32),
           torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        K.qmatmul_exact(a.to(torch.int32), b, *epi)
    with pytest.raises(ValueError, match="contiguous"):
        K.qmatmul_exact(torch.zeros((8, 4), dtype=torch.int8).t(), b, *epi)
    with pytest.raises(ValueError):
        K.qmatmul_exact(a, torch.zeros((7, 3), dtype=torch.int8), *epi)
    with pytest.raises(ValueError, match="rounding"):
        K.qmatmul_exact(a, b, *epi, rounding="nearest")
    x = torch.zeros((1, 5, 5, 2), dtype=torch.int8)
    with pytest.raises(ValueError):
        K.qconv2d_exact(x, torch.zeros((9 * 3, 3), dtype=torch.int8), *epi,
                        kh=3, kw=3)
    with pytest.raises(ValueError):
        K.qdwconv2d_exact(x, torch.zeros((9, 3), dtype=torch.int8), *epi,
                          kh=3, kw=3)
    add = dict(_ADD_ARGS, sign=1, out_dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        K.qaddsub(x.to(torch.int32), x, **add)
    with pytest.raises(ValueError, match="shape"):
        K.qaddsub(x, x[:, :1], **add)
    with pytest.raises(ValueError, match="contiguous"):
        K.qaddsub(x.transpose(1, 2), x, **add)
    with pytest.raises(ValueError, match="out_dtype"):
        K.qaddsub(x, x, **dict(add, out_dtype=torch.int32))
    with pytest.raises(ValueError, match="rounding"):
        K.qaddsub(x, x, **add, rounding="nearest")
    with pytest.raises(ValueError, match="sho"):
        K.qaddsub(x, x, **dict(add, sho=31))


def test_cpu_tensors_take_the_plain_version_without_launching():
    K.reset_launches()
    rng = np.random.default_rng(16)
    a = _t(rng.integers(-128, 128, (6, 8)).astype(np.int8))
    b = _t(rng.integers(-128, 128, (8, 3)).astype(np.int8))
    bias, qm, sh = (_t(v) for v in _epilogue(rng, 3, 8))
    out = K.qmatmul_exact(a, b, bias, qm, sh)
    assert out.device.type == "cpu"
    x = _t(rng.integers(-128, 128, (2, 5, 5, 3)).astype(np.int8))
    out = K.qaddsub(x, x, **_ADD_ARGS, sign=-1, out_dtype=torch.int8)
    assert out.device.type == "cpu"
    assert all(n == 0 for n in K.launch_counts().values())
