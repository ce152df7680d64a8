"""TRANSPOSE_CONV in the PyTorch port, on the CPU: the phase convolutions
through kernel B2's plain version (B2 fast's in fast numerics), on every
deconv of tconv_int8 (odd output 11x11 and 17x17 through the strided
scatter, even 10x10 through the pixel shuffle), FSRCNN-small's 9x9 56 -> 1
deconv and cnn_ops_int8's two 12-channel deconvs.

- exact numerics: byte-equal (tolerance 0) to the TFLite interpreter,
  the one reference (band_tpu rounds every channel as ruy; TFLite rounds
  channels 8*floor(Oc/8) and up with double rounding: ROADMAP fault C3);
- fast numerics: byte-equal to band_tpu's fast program;
- a weight zero point != 0 (tconv_int8's weights requantized per tensor
  with zero point 5): exact against a scatter-form numpy reference with
  the same requant, fast against band_tpu;
- a stacked window of 4 requests equals 4 runs of one.
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
from band_tpu_torch.backend.executor import ModelExecutor
from band_tpu_torch.backend.program import build_program as tbuild
from band_tpu_torch.backend.program import params_from_jax
from band_tpu_torch.ir.graph import QuantParams
from band_tpu_torch.ops import kernels as K
from band_tpu_torch.ops import quant as Q
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse
from tests.conftest import make_tfl_interpreter

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# (model, op index, pixel shuffle, rounding groups of the exact program)
DECONVS = [
    ("tconv_int8", 3, False, ("ruy",)),
    ("tconv_int8", 6, True, ("ruy",)),
    ("tconv_int8", 8, False, ("ruy",)),
    ("fsrcnn_x2_small_int8", 17, True, ("double",)),
    ("cnn_ops_int8", 23, False, ("ruy", "double")),
    ("cnn_ops_int8", 42, True, ("ruy", "double")),
]
IDS = [f"{m}-{i}" for m, i, _, _ in DECONVS]
SEEDS = (0, 1, 2)


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    return tparse(_path(name)), jparse(_path(name))


@functools.lru_cache(maxsize=None)
def _tensors(name, seed):
    it = make_tfl_interpreter(_path(name),
                              experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    ind = it.get_input_details()[0]
    rng = np.random.default_rng(100 + seed)
    it.set_tensor(ind["index"], rng.integers(-128, 128, size=ind["shape"])
                  .astype(ind["dtype"]))
    it.invoke()
    g = _graphs(name)[0]
    out = {}
    for op in g.ops:
        if op.opname == "TRANSPOSE_CONV":
            for t in op.inputs[:3] + op.outputs:
                if not g.tensor(t).is_constant:
                    out[t] = np.array(it.get_tensor(t))
    return out


def _pixel_shuffle(prog, op):
    """Whether the union conv's phases interleave into the whole output
    (each stride divides the output size), with no rows or columns cut."""
    t_h, t_w = prog.meta[f"op{op.index}/tiles"]
    return (t_h * op.options["stride_h"], t_w * op.options["stride_w"]) == \
        tuple(prog.meta[f"op{op.index}/out_hw"])


def _port(g, index, feeds, exact=True):
    """The one-op program, fed the output-shape input (when it is not a
    constant) and x from ``feeds``."""
    prog = tbuild(g, [index], exact=exact)
    (out,) = prog.make_fn()(params_from_jax(prog.params),
                            [torch.from_numpy(feeds[t])
                             for t in prog.input_ids])
    return prog, out.numpy()


def _band_tpu(g, index, feeds, exact):
    prog = jbuild(g, [index], exact=exact, conv_mode="f32_split")
    (out,) = jax.jit(prog.make_fn())(prog.params,
                                     [feeds[t] for t in prog.input_ids])
    return np.asarray(out)


@pytest.mark.parametrize("name,index,even,roundings", DECONVS, ids=IDS)
def test_exact_matches_tflite(name, index, even, roundings):
    tg = _graphs(name)[0]
    op = tg.ops[index]
    for seed in SEEDS:
        t = _tensors(name, seed)
        prog, got = _port(tg, index, t)
        np.testing.assert_array_equal(got, t[op.outputs[0]],
                                      err_msg=f"seed {seed}")
    assert _pixel_shuffle(prog, op) == even
    assert tuple(r for _, _, r in prog.meta[f"op{index}/groups"]) == \
        roundings


@pytest.mark.parametrize("name,index,even,roundings", DECONVS, ids=IDS)
def test_fast_matches_band_tpu(name, index, even, roundings):
    tg, jg = _graphs(name)
    op = tg.ops[index]
    for seed in SEEDS:
        t = _tensors(name, seed)
        prog, got = _port(tg, index, t, exact=False)
        np.testing.assert_array_equal(got, _band_tpu(jg, index, t, False),
                                      err_msg=f"seed {seed}")
    assert len(prog.meta[f"op{index}/groups"]) == 1


def test_band_tpu_rounding_differs_from_tflite():
    """The record of fault C3: on FSRCNN-small's deconv (one output
    channel) band_tpu's exact TRANSPOSE_CONV differs from TFLite; the
    port's does not (test_exact_matches_tflite)."""
    tg, jg = _graphs("fsrcnn_x2_small_int8")
    op = tg.ops[17]
    differ = 0
    for seed in SEEDS:
        t = _tensors("fsrcnn_x2_small_int8", seed)
        want = t[op.outputs[0]].astype(np.int64)
        got = _band_tpu(jg, 17, t, True).astype(np.int64)
        assert np.abs(got - want).max() <= 1
        differ += int((got != want).sum())
    print(f"band_tpu differs from TFLite on {differ} of "
          f"{len(SEEDS) * want.size} outputs")
    assert differ > 0


def _with_weight_zero_point(g, index, zp=5):
    """A copy of ``g`` whose deconv ``index`` has per-tensor int8 weights
    with zero point ``zp`` (the per-channel weights rescaled)."""
    g = copy.deepcopy(g)
    w = g.tensor(g.ops[index].inputs[1])
    real = w.data.astype(np.float64) * w.quant.scale.reshape(-1, 1, 1, 1)
    s = float(np.abs(real).max()) / 120.0
    w.data = np.clip(np.round(real / s) + zp, -128, 127).astype(np.int8)
    w.quant = QuantParams(np.array([s], np.float32), np.array([zp], np.int64))
    return g


def _scatter_reference(g, op, x, prog):
    """TFLite's TransposeConv in its scatter form, in numpy int64: every
    input pixel adds (x - x_zp) * (w - w_zp) to the output window it
    spreads over; then the bias and the program's own requant."""
    w_td, x_td = g.tensor(op.inputs[1]), g.tensor(op.inputs[2])
    out_td = g.tensor(op.outputs[0])
    xzp = int(x_td.quant.zero_point[0])
    w = w_td.data.astype(np.int64) - int(w_td.quant.zero_point[0])
    n, h, wd, ci = x.shape
    oc, kh, kw, _ = w.shape
    s_h, s_w = op.options["stride_h"], op.options["stride_w"]
    oh, ow = out_td.shape[1:3]
    pt = max((h - 1) * s_h + kh - oh, 0) // 2 \
        if op.options["padding"] == "SAME" else 0
    pl = max((wd - 1) * s_w + kw - ow, 0) // 2 \
        if op.options["padding"] == "SAME" else 0
    acc = np.zeros((n, (h - 1) * s_h + kh, (wd - 1) * s_w + kw, oc), np.int64)
    xi = x.astype(np.int64) - xzp
    for ky in range(kh):
        for kx in range(kw):
            acc[:, ky:ky + (h - 1) * s_h + 1:s_h,
                kx:kx + (wd - 1) * s_w + 1:s_w] += np.einsum(
                    "nhwc,oc->nhwo", xi, w[:, ky, kx, :])
    acc = acc[:, pt:pt + oh, pl:pl + ow]
    if len(op.inputs) > 3 and op.inputs[3] >= 0:
        acc = acc + g.tensor(op.inputs[3]).data.astype(np.int64)
    meta = prog.meta
    out = []
    for gi, (c0, c1, rounding) in enumerate(meta[f"op{op.index}/groups"]):
        # the union's multipliers: the group's, once per phase
        qm, shift = (np.asarray(prog.params[f"op{op.index}/{k}_{gi}"])
                     for k in ("qm", "shift"))
        for v in (qm, shift):
            np.testing.assert_array_equal(
                v, np.tile(v[:c1 - c0], s_h * s_w))
        out.append(Q.requantize_exact(
            torch.from_numpy(acc[..., c0:c1]),
            torch.from_numpy(qm[:c1 - c0]), torch.from_numpy(shift[:c1 - c0]),
            meta[f"op{op.index}/out_zp"], meta[f"op{op.index}/qmin"],
            meta[f"op{op.index}/qmax"], out_td.dtype, rounding).numpy())
    return np.concatenate(out, axis=-1)


@pytest.mark.parametrize("name,index,even,roundings", DECONVS, ids=IDS)
def test_weight_zero_point(name, index, even, roundings):
    tg = _with_weight_zero_point(_graphs(name)[0], index)
    jg = _with_weight_zero_point(_graphs(name)[1], index)
    op = tg.ops[index]
    t = _tensors(name, 0)
    prog, got = _port(tg, index, t)
    assert prog.meta[f"op{index}/w_zp"] == 5
    np.testing.assert_array_equal(
        got, _scatter_reference(tg, op, t[op.inputs[2]], prog))
    _, fast = _port(tg, index, t, exact=False)
    np.testing.assert_array_equal(fast, _band_tpu(jg, index, t, False))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name", ["tconv_int8", "fsrcnn_x2_small_int8"])
def test_stacked_window_of_four_matches_single_requests(name, exact):
    """The whole model (prelude, phase convs, interleaves) on a stacked
    window of 4 requests equals 4 single runs, through B2's calls."""
    g = _graphs(name)[0]
    td = g.tensor(g.inputs[0])
    rng = np.random.default_rng(4)
    xs = [rng.integers(-128, 128, size=td.shape).astype(np.int8)
          for _ in range(4)]
    ex = ModelExecutor(0, g, 0, torch.device("cpu"), exact=exact)
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    before = (K.LAUNCHES["qconv2d_exact"].n, K.LAUNCHES["qconv2d_fast"].n)
    batch = ex.execute_batched(key, [[x] for x in xs])
    assert ex.windows[4] == 1
    for x, outs in zip(xs, batch):
        single = ex.execute(key, [x])
        assert len(outs) == len(single) == len(g.outputs)
        for a, b in zip(outs, single):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the plain versions ran: nothing was counted as a kernel launch
    assert (K.LAUNCHES["qconv2d_exact"].n,
            K.LAUNCHES["qconv2d_fast"].n) == before


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_phase_without_taps(exact):
    """A stride above the kernel size leaves phases with no taps (here
    tconv_int8's 3x3 deconv at stride 4, output 19x19: phase 3 of each
    axis): their outputs are the requantized bias alone, the all-fill
    branch.  Against band_tpu (whose per-channel multipliers and, for 16
    channels, rounding are the port's) and, exact, the scatter form."""
    graphs = []
    for g in _graphs("tconv_int8"):
        g = copy.deepcopy(g)
        op = g.ops[3]
        op.options.update(stride_h=4, stride_w=4)
        g.tensor(op.outputs[0]).shape = (1, 19, 19, 16)
        graphs.append(g)
    tg, jg = graphs
    op = tg.ops[3]
    t = dict(_tensors("tconv_int8", 0))
    t[op.inputs[0]] = np.array([1, 19, 19, 16], np.int32)
    prog, got = _port(tg, 3, t, exact=exact)
    # the union's phases without taps: their kernel slices hold w_zp only
    w = np.asarray(prog.params["op3/w_0"])
    w = w.reshape(w.shape[0], 16, -1)  # [taps * Ci, phase, channel]
    tapless = [p for p in range(16)
               if (w[:, p] == prog.meta["op3/w_zp"]).all()]
    assert tapless == [3, 7, 11, 12, 13, 14, 15]  # phase 3 of either axis
    assert not _pixel_shuffle(prog, op)
    np.testing.assert_array_equal(got, _band_tpu(jg, 3, t, exact))
    if exact:
        np.testing.assert_array_equal(
            got, _scatter_reference(tg, op, t[op.inputs[2]], prog))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("name,index,even,roundings", DECONVS, ids=IDS)
def test_one_b2_call_per_rounding_group(name, index, even, roundings, exact,
                                        monkeypatch):
    """The lowering runs every sub-pixel phase of a rounding group as one
    B2 call (B2 fast in fast numerics), counted through a wrapper on the
    CPU: each over the deconv's input x, with the union's taps and the
    phases' channels (sh * sw of each of the group's channels); and the
    result stays TFLite's (exact) or band_tpu's (fast)."""
    from band_tpu_torch.ops import lowerings as L

    tg, jg = _graphs(name)
    op = tg.ops[index]
    t = _tensors(name, 0)
    kernel = "qconv2d_exact" if exact else "qconv2d_fast"
    calls = []

    def count(f):
        def g(*args, **kw):
            calls.append((args, kw))
            return f(*args, **kw)
        return g

    monkeypatch.setattr(L, kernel, count(getattr(L, kernel)))
    prog, got = _port(tg, index, t, exact=exact)
    groups = prog.meta[f"op{index}/groups"]
    assert len(calls) == len(groups) == (len(roundings) if exact else 1)
    phases = op.options["stride_h"] * op.options["stride_w"]
    for (c0, c1, _), (args, kw) in zip(groups, calls):
        assert tuple(args[0].shape) == t[op.inputs[2]].shape
        assert (kw["kh"], kw["kw"]) == tuple(prog.meta[f"op{index}/taps"])
        assert args[1].shape[1] == phases * (c1 - c0)
    want = t[op.outputs[0]] if exact else _band_tpu(jg, index, t, False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,index,even,roundings", DECONVS, ids=IDS)
def test_union_places_each_phase_at_its_offset(name, index, even,
                                               roundings):
    """The union conv's kernel, per phase (rh, rw): the slice w[u0::s] of
    the 180-degree-rotated kernel at the phase's input offset (off - lo)
    on each axis, w_zp on every other tap of the window.  tconv_int8's
    3x3 and cnn_ops_int8's deconvs have phases with different offsets
    (-1 and 0) and tap counts (2 and 1); FSRCNN's both at -2, with 5 and
    4 taps."""
    from band_tpu_torch.ops.lowerings import (_tconv_pads, _tconv_phases,
                                              _tconv_window)

    tg = _graphs(name)[0]
    op = tg.ops[index]
    prog = tbuild(tg, [index])
    meta = lambda k: prog.meta[f"op{index}/{k}"]  # noqa: E731
    w_td = tg.tensor(op.inputs[1])
    x_td = tg.tensor(op.inputs[2])
    oc, kh, kw, ci = w_td.shape
    w = np.transpose(w_td.data[:, ::-1, ::-1, :], (1, 2, 3, 0))
    sh, sw = op.options["stride_h"], op.options["stride_w"]
    out_h, out_w = meta("out_hw")
    in_h, in_w = x_td.shape[1:3]
    pb_h, pb_w = _tconv_pads(op.options, in_h, in_w, kh, kw, sh, sw, out_h,
                             out_w)
    ph = _tconv_phases(kh, sh, pb_h, out_h)
    pw = _tconv_phases(kw, sw, pb_w, out_w)
    lo_h, uh, pads_h, _, _ = _tconv_window(ph, in_h)
    lo_w, uw, pads_w, _, _ = _tconv_window(pw, in_w)
    assert meta("taps") == (uh, uw) and meta("pads") == (pads_h, pads_w)
    if (name, index) in (("tconv_int8", 3), ("cnn_ops_int8", 23)):
        assert len({off for _, _, off, _ in ph}) == 2
    wzp = meta("w_zp")
    for g, (c0, c1, _) in enumerate(meta("groups")):
        wu = np.asarray(prog.params[f"op{index}/w_{g}"]).reshape(
            uh, uw, ci, sh * sw, c1 - c0)
        for rh, (u0h, kah, offh, _) in enumerate(ph):
            for rw, (u0w, kaw, offw, _) in enumerate(pw):
                want = np.full((uh, uw, ci, c1 - c0), wzp, np.int64)
                want[offh - lo_h:offh - lo_h + kah,
                     offw - lo_w:offw - lo_w + kaw] = \
                    w[u0h::sh, u0w::sw, :, c0:c1].astype(np.int64)
                np.testing.assert_array_equal(
                    wu[:, :, :, rh * sw + rw], want, err_msg=f"{rh},{rw}")
