#!/usr/bin/env python3
"""Smoke run of band_tpu_torch on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs
one CUDA card and nvcc; without them, or without the package beside it,
it exits non-zero and prints no result.  It imports neither jax nor
band_tpu.  Every failed check raises, and the script exits non-zero.

Phases:
 1. device   the card's name and power limit (nvidia-smi).
 2. build    every kernel under band_tpu_torch/ops/kernels/csrc, one nvcc
             per source, all at once.
 3. kernels  each kernel held byte-equal (tolerance 0) to its plain
             PyTorch version on the card:
             - on every call a full-width MobileNetV2 request makes, at
               b1 and at b8, with exact numerics and with fast numerics
               (captured from the model's programs run on the card, real
               weights and activations);
             - on synthetic cases: all three roundings, w_zp 0 and != 0,
               int8 and uint8 outputs, ragged K, conv strides 1/2 and
               dilation 2, depthwise stride 2, dilation 2 and depth
               multiplier 2; for both depthwise kernels every branch of
               dwconv_plan and every variant of the strip kernel, each
               with w_zp 0 and != 0 and int8 and uint8 outputs (ragged
               C 7/13/33, multiplier 3, 5x5, stride (2, 1), x one byte
               off alignment, ...); for both convs every branch of
               conv_plan (its own plan on stems and small-Ci convs, the
               general loop) and every direct variant and the general
               loop forced, each with w_zp 0 and != 0 and int8 and uint8
               outputs; for the softmax every branch of softmax_plan
               (the thread kernel, the row kernel at 32, 64 and 256
               threads) on 1 and 8 rows of depth 10, 1000 and 1001, int8
               and uint8 in and out; for the fast kernels also per-tensor and
               per-channel mult, mult 0.5 on odd sums (ties to even) and
               sums above 2^24; for both GEMMs every branch of gemm_plan
               (M 0..12545, K 16..1280, N 16..1000: each tile, K split or
               not, 16-, 8- and 1-byte copies, A one byte off alignment)
               and a bias near +-2^31 under split-K.
             At MobileNetV2's b1 calls each kernel is timed (a CUDA graph
             of 20 launches, replayed), beside its plain version (eager,
             CUDA events), its bound, and a yardstick: for the int8
             GEMMs one torch._int_mm call per GEMM, for the depthwise
             convs one cuDNN call per conv; one ``gemm:``
             line per distinct b1 GEMM shape (plan, exact, fast and
             _int_mm times), one ``dwconv:`` line per distinct b1
             depthwise shape (plan, exact, fast, library and bound; the
             library is one cuDNN float32 depthwise conv, checked equal
             to the kernel's accumulator first), and the ``launch
             floor:`` line: one trivial
             PyTorch kernel in the same CUDA-graph harness, and 35 times
             it.  Then, from the real calls of the five tests/data models
             at b1 and b8, one ``qconv:`` line per distinct B2 shape
             (plan, B2 and B2 fast, both with the general loop forced,
             a cuDNN float32 conv as yardstick, bound) and one
             ``softmax:`` line per distinct SOFTMAX shape (plan, the
             thread and the row kernel forced, torch.softmax in float32
             as yardstick, the bytes bound and the serial floor of the
             float32 row sum).
 4. engine   Engine.create with one GPU worker (fixed_worker, max_batch
             8); the full-width MobileNetV2 and the three tests/data CNNs
             registered and served: 4 checked request_sync, 32 timed
             request_sync, then a burst of 32 request_async.  Every
             output is byte-equal to the TFLite golden.  Launch counts
             are zeroed just before this phase and read just after; each
             exact kernel must have launched, and no fast one.
 5. fast     the same with numerics("fast") engine-wide, and
             quant_act_int8 besides: every output byte-equal to the fast
             golden (tests/data/torch_fast_goldens.npz); each fast
             kernel must have launched in this phase, and none of the
             exact GEMM and conv kernels.
 6. mixed    one engine with the default exact numerics registers
             MobileNetV2 and quant_act_int8 twice each, once with
             register_model(numerics="fast"), and serves them
             interleaved: exact models byte-equal to the TFLite goldens,
             fast models to the fast goldens.
 7. depth    the logits below each model's SOFTMAX, from the program on
             the card at b1 and stacked b8, byte-equal to the golden
             logits; and the fast program's output below the first MEAN,
             byte-equal to band_tpu's fast output stored in the fast
             goldens.
 8. profile  a b1 MobileNetV2 request through the executor, exact and
             fast: its wall time, and the device time of its kernels
             (torch.profiler).
Then it prints the kernels line, and last the device line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLDENS = os.path.join(DATA, "torch_goldens.npz")
FAST_GOLDENS = os.path.join(DATA, "torch_fast_goldens.npz")
FULL_WIDTH = "mobilenet_v2_int8"
MODELS = (FULL_WIDTH, "effnetlite_int8", "resnetish_int8", "fc_int8")
QUANT_ACT = "quant_act_int8"
FAST_MODELS = MODELS + (QUANT_ACT,)
MAX_BATCH = 8
SYNC_CHECKED = 4
SYNC_TIMED = 32
BURST = 32

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
FADD_CYCLES = 4  # latency of a dependent float32 add (the softmax's serial sum)

KERNELS = {
    "qmatmul_exact": dict(
        source="band_tpu_torch/ops/kernels/csrc/qmatmul.cu",
        replaces="band_tpu/ops/pallas/qmatmul.py:135"),
    "qconv2d_exact": dict(
        source="band_tpu_torch/ops/kernels/csrc/qconv.cu",
        replaces="band_tpu/ops/pallas/qconv.py:152"),
    "qdwconv2d_exact": dict(
        source="band_tpu_torch/ops/kernels/csrc/qdwconv.cu",
        replaces="band_tpu/ops/pallas/qdwconv.py:114"),
    "lut_softmax": dict(
        source="band_tpu_torch/ops/kernels/csrc/lut_softmax.cu",
        replaces="band_tpu/ops/quant.py:443"),
    "qmatmul_fast": dict(
        source="band_tpu_torch/ops/kernels/csrc/qmatmul.cu",
        replaces="band_tpu/ops/pallas/qmatmul.py:42"),
    # the fast convs were XLA convs + requantize_fast on the TPU
    "qconv2d_fast": dict(
        source="band_tpu_torch/ops/kernels/csrc/qconv.cu",
        replaces="band_tpu/ops/lowerings.py:563"),
    "qdwconv2d_fast": dict(
        source="band_tpu_torch/ops/kernels/csrc/qdwconv.cu",
        replaces="band_tpu/ops/lowerings.py:943"),
}
FAST = ("qmatmul_fast", "qconv2d_fast", "qdwconv2d_fast")
EXACT_ONLY = ("qmatmul_exact", "qconv2d_exact", "qdwconv2d_exact")


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# goldens (tests/gen_torch_goldens.py writes them)
# --------------------------------------------------------------------------

def golden_inputs(seed, shape, dtype, n):
    """The generator's request inputs: uniform over the dtype's range."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, info.max + 1, size=(n, *shape),
                        dtype=np.int64).astype(dtype)


def _inputs(z, name, g, n):
    import hashlib

    td = g.tensor(g.inputs[0])
    xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype, n)
    sha = hashlib.sha256(np.ascontiguousarray(xs).tobytes()).hexdigest()
    check(sha == str(z[f"{name}/input_sha"]),
          f"{name}: regenerated inputs differ from the goldens'")
    return xs


def load_goldens(graphs):
    """Exact goldens (TFLite) of MODELS: xs, output (one array per model
    output), logits."""
    z = np.load(GOLDENS)
    out = {}
    for name in MODELS:
        want = z[f"{name}/output"]
        out[name] = dict(xs=_inputs(z, name, graphs[name], len(want)),
                         output=[want], logits=z[f"{name}/logits"],
                         logits_tid=int(z[f"{name}/logits_tid"]))
    return out


def load_fast_goldens(graphs):
    """Fast goldens (tests/gen_torch_fast_goldens.py) of FAST_MODELS:
    xs, output (one array per model output), seg0 (band_tpu's fast output
    of the program below the first MEAN, and its op range); for
    quant_act_int8 also its TFLite goldens, ``exact``."""
    z = np.load(FAST_GOLDENS)
    out = {}
    for name in FAST_MODELS:
        n_out = len(graphs[name].outputs)
        want = [z[f"{name}/fast_output{j}"] for j in range(n_out)]
        a, b = (int(v) for v in z[f"{name}/seg0/ops"])
        out[name] = dict(xs=_inputs(z, name, graphs[name], len(want[0])),
                         output=want, seg0_ops=range(a, b),
                         seg0=z[f"{name}/seg0/out0"])
        if f"{name}/tflite_output0" in z:
            out[name]["exact"] = [z[f"{name}/tflite_output{j}"]
                                  for j in range(n_out)]
    return out


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def graph_ms(torch, fn, launches=20, replays=10):
    """Device time of one fn() call: ``launches`` calls captured in a
    CUDA graph, replayed, timed with CUDA events (no host overhead)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def eager_ms(torch, fn, iters=5):
    """Time of one eager fn() call on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def work(name, args, kw, out):
    """(bytes, ops, ops per second) of one kernel call: each input read
    once, each output written once; int8 MACs count two operations."""
    if name != "lut_softmax":
        # int8 GEMM or conv: inputs, weights, the epilogue's vectors
        # (bias, qm, shift; or bias, mult) and the output
        x, w = args[0], args[1]
        epi = sum(4 * t.numel() for t in args[2:] if hasattr(t, "numel"))
        nbytes = x.numel() + w.numel() + epi + out.numel()
        return nbytes, 2 * out.numel() * w.shape[0], INT8_OPS_PER_S
    # lut_softmax: a table read, an add, a multiply and a round per
    # element, in float32 outside the tensor cores
    x = args[0]
    return 2 * x.numel() + 4 * 256, 4 * x.numel(), FP32_OPS_PER_S


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

def dwconv_plan_of(args, kw, out):
    """The dwconv_plan a depthwise kernel call ran under."""
    from band_tpu_torch.ops.kernels import qdwconv as QD

    x, w = args[0], args[1]
    n, _, _, c = x.shape
    return QD.dwconv_plan(n, out.shape[1], out.shape[2], c, w.shape[1] // c,
                          kw["kh"], kw["kw"], tuple(kw["stride"]),
                          tuple(kw["dilation"]), QD.alignment(x, w, out))


def conv_library(torch, dev, args, kw, depthwise):
    """The conv kernels' yardstick (B2 and B3, exact and fast): one cuDNN
    float32 convolution (channels_last, TF32 off; groups = C for the
    depthwise conv) on inputs already converted (x_zp-padded and float),
    which computes the kernel's accumulator exactly (|acc| <= kh * kw *
    Ci * 128 * 128 < 2^24 at these sizes).  Checked equal to _acc_plain
    without bias first; returns the call to time.  The port never calls
    it, and no PyTorch call computes either conv with its requant."""
    import torch.nn.functional as F
    from band_tpu_torch.ops.kernels import qconv as QC
    from band_tpu_torch.ops.kernels import qdwconv as QD

    x, w = args[0], args[1]
    kh, kw_ = kw["kh"], kw["kw"]
    (pt, pb), (pl, pr) = kw["padding"]
    ci, co = x.shape[3], w.shape[1]
    check(not torch.backends.cudnn.allow_tf32, "cuDNN with TF32")
    xf = F.pad(x.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb),
               value=float(kw["x_zp"])).contiguous(
                   memory_format=torch.channels_last)
    if depthwise:
        wt = w.float().reshape(kh, kw_, co).permute(2, 0, 1).unsqueeze(1)
    else:
        wt = w.float().reshape(kh, kw_, ci, co).permute(3, 2, 0, 1)
    wf = wt.contiguous(memory_format=torch.channels_last)
    groups = ci if depthwise else 1

    def run():
        return F.conv2d(xf, wf, stride=tuple(kw["stride"]),
                        dilation=tuple(kw["dilation"]), groups=groups)

    acc_plain = (QD if depthwise else QC)._acc_plain
    want = acc_plain(x, w, torch.zeros(co, dtype=torch.int32, device=dev),
                     kh, kw_, kw["stride"], kw["dilation"], kw["padding"],
                     kw["x_zp"], 0)
    got = run().permute(0, 2, 3, 1).to(torch.int64)
    check(torch.equal(got, want),
          f"cuDNN conv {tuple(x.shape)} differs from _acc_plain")
    return run


def softmax_library(torch, args):
    """lut_softmax's yardstick: torch.softmax in float32 over the same
    rows (the int8 input as float).  Not the quantized function: no
    PyTorch call computes TFLite's table softmax with its float32 row
    sum and requant.  The port never calls it."""
    xf = args[0].float()
    return lambda: torch.softmax(xf, dim=-1)


def capture_calls(L, fn, params, inputs):
    """Every kernel call one run of ``fn`` makes: (name, args, kwargs,
    output).  The lowerings call the kernels through their module
    globals, which are wrapped for the run."""
    calls = []
    saved = {n: getattr(L, n) for n in KERNELS}

    def wrap(name, f):
        def g(*args, **kw):
            out = f(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return g

    try:
        for n, f in saved.items():
            setattr(L, n, wrap(n, f))
        fn(params, inputs)
    finally:
        for n, f in saved.items():
            setattr(L, n, f)
    return calls


def same(torch, name, got, want, what):
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} {what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    err = ((got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
           if got.numel() else 0)
    check(err == 0, f"{name} {what}: max |kernel - plain| = {err}")
    return err


def synthetic_cases(torch, K, Q, dev):
    """(name, kernel thunk, plain thunk, label) of the synthetic cases."""
    rng = np.random.default_rng(7)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def epilogue(n, k, per_channel=True):
        # multipliers that map the accumulator's spread to ~30 units
        std = max(np.sqrt(k) * 73.0 * 73.0, 1.0)
        m = (30.0 / std) * rng.uniform(0.5, 2.0, n if per_channel else 1)
        qm, sh = Q.quantize_multipliers(m)
        bias = rng.integers(-20000, 20000, n).astype(np.int32)
        return t(bias), t(qm), t(sh)

    def out_args(out_dtype, rounding, w_zp):
        if out_dtype == torch.uint8:
            return dict(out_zp=128, qmin=0, qmax=255, rounding=rounding,
                        w_zp=w_zp, out_dtype=out_dtype)
        return dict(out_zp=-3, qmin=-128, qmax=127, rounding=rounding,
                    w_zp=w_zp, out_dtype=out_dtype)

    def i8(*shape):
        return t(rng.integers(-128, 128, shape).astype(np.int8))

    cases = []
    grid = [(r, z, o) for r in ("single", "double", "ruy") for z in (0, 7)
            for o in (torch.int8, torch.uint8)]
    for rounding, w_zp, od in grid:
        for m, k, n in ((200, 96, 72), (33, 27, 10)):
            a, b = i8(m, k), i8(k, n)
            ep = epilogue(n, k)
            kw = out_args(od, rounding, w_zp)
            cases.append(("qmatmul_exact",
                          lambda a=a, b=b, ep=ep, kw=kw:
                          K.qmatmul_exact(a, b, *ep, **kw),
                          lambda a=a, b=b, ep=ep, kw=kw:
                          K.qmatmul_plain(a, b, *ep, **kw),
                          f"M{m} K{k} N{n} {rounding} w_zp={w_zp} {od}"))
    # per-tensor multiplier, MobileNetV2-like pointwise shape
    a, b = i8(3136, 144), i8(144, 24)
    ep = epilogue(24, 144, per_channel=False)
    kw = out_args(torch.int8, "ruy", 0)
    cases.append(("qmatmul_exact",
                  lambda a=a, b=b, ep=ep, kw=kw:
                  K.qmatmul_exact(a, b, *ep, **kw),
                  lambda a=a, b=b, ep=ep, kw=kw:
                  K.qmatmul_plain(a, b, *ep, **kw),
                  "M3136 K144 N24 per-tensor qm"))
    conv_geoms = [
        # (n, h, w, ci, oc, kh, kw, stride, dilation, padding)
        (2, 17, 15, 8, 24, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))),
        (2, 17, 16, 3, 32, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))),
        (1, 19, 19, 16, 70, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))),
        (2, 12, 12, 5, 9, 5, 5, (1, 2), (1, 1), ((2, 2), (1, 2))),
    ]
    for i, (n, h, w, ci, oc, kh, kw_, st, dil, pad) in enumerate(conv_geoms):
        rounding, w_zp, od = grid[(3 * i) % len(grid)]
        for w_zp in (0, -5):
            x, wk = i8(n, h, w, ci), i8(kh * kw_ * ci, oc)
            ep = epilogue(oc, kh * kw_ * ci)
            kw = dict(out_args(od, rounding, w_zp), kh=kh, kw=kw_, stride=st,
                      dilation=dil, padding=pad, x_zp=-9)
            cases.append(("qconv2d_exact",
                          lambda x=x, wk=wk, ep=ep, kw=kw:
                          K.qconv2d_exact(x, wk, *ep, **kw),
                          lambda x=x, wk=wk, ep=ep, kw=kw:
                          K.qconv2d_plain(x, wk, *ep, **kw),
                          f"{kh}x{kw_} ci{ci} oc{oc} s{st} d{dil} {rounding} "
                          f"w_zp={w_zp} {od}"))
    dw_geoms = [
        # (n, h, w, c, mult, kh, kw, stride, dilation, padding)
        (2, 19, 19, 32, 1, 3, 3, (1, 1), (1, 1), ((1, 1), (1, 1))),
        (2, 20, 18, 24, 1, 3, 3, (2, 2), (1, 1), ((0, 1), (0, 1))),
        (1, 15, 15, 16, 1, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))),
        (2, 11, 13, 12, 2, 3, 3, (2, 1), (1, 1), ((1, 1), (1, 1))),
    ]
    for i, (n, h, w, c, mult, kh, kw_, st, dil, pad) in enumerate(dw_geoms):
        rounding, w_zp, od = grid[(5 * i + 1) % len(grid)]
        for w_zp in (0, 3):
            x, wk = i8(n, h, w, c), i8(kh * kw_, c * mult)
            ep = epilogue(c * mult, kh * kw_)
            kw = dict(out_args(od, rounding, w_zp), kh=kh, kw=kw_, stride=st,
                      dilation=dil, padding=pad, x_zp=11)
            cases.append(("qdwconv2d_exact",
                          lambda x=x, wk=wk, ep=ep, kw=kw:
                          K.qdwconv2d_exact(x, wk, *ep, **kw),
                          lambda x=x, wk=wk, ep=ep, kw=kw:
                          K.qdwconv2d_plain(x, wk, *ep, **kw),
                          f"c{c} x{mult} s{st} d{dil} {rounding} "
                          f"w_zp={w_zp} {od}"))
    cases += gemm_plan_cases(torch, K, Q, rng, t, i8, epilogue, out_args)
    cases += dwconv_plan_cases(torch, K, rng, i8, epilogue, out_args)
    cases += conv_plan_cases(torch, K, rng, i8, epilogue, out_args)
    cases += softmax_plan_cases(torch, K, Q, rng, t)
    cases += fast_synthetic_cases(torch, K, rng, t, i8, out_args)
    for in_dtype, od, depth in ((np.int8, torch.int8, 1000),
                                (np.uint8, torch.uint8, 10),
                                (np.int8, torch.int8, 37)):
        info = np.iinfo(in_dtype)
        x = t(rng.integers(info.min, info.max + 1, (8, depth))
              .astype(in_dtype))
        table = t(Q.softmax_table(0.0625, 1.0))
        zp = -128 if od == torch.int8 else 0
        cases.append(("lut_softmax",
                      lambda x=x, table=table, od=od, zp=zp:
                      K.lut_softmax(x, table, 1.0 / 256, zp, od),
                      lambda x=x, table=table, od=od, zp=zp:
                      K.lut_softmax_plain(x, table, 1.0 / 256, zp, od),
                      f"rows 8 depth {depth} {od}"))
    return cases


def gemm_plan_cases(torch, K, Q, rng, t, i8, epilogue, out_args):
    """Both GEMMs on every branch of gemm_plan: each block tile, K split
    or not, A and B rows copied 16, 8 or 1 byte at a time (a third of the
    cases take A one byte into a buffer); all roundings, w_zp 0 and 5,
    int8 and uint8 out, per-channel and per-tensor multipliers in turn.
    Then a bias near +-2^31, so that the sums wrap, under split-K."""
    cases = []
    shapes = [(m, k, n) for m in (0, 1, 7, 49, 392, 12545)
              for k in (16, 24, 27, 960, 1280) for n in (16, 24, 1000)]
    for i, (m, k, n) in enumerate(shapes):
        if i % 3 == 1:
            a = i8(m * k + 1)[1:].view(m, k)
        else:
            a = i8(m, k)
        b = i8(k, n)
        rounding = ("single", "double", "ruy")[i % 3]
        kw = out_args((torch.int8, torch.uint8)[i % 2], rounding,
                      (0, 5)[(i // 2) % 2])
        ep = epilogue(n, k, per_channel=i % 4 < 2)
        plan = K.gemm_plan(m, n, k)
        label = (f"M{m} K{k} N{n} tile {plan.bm}x{plan.bn} splits "
                 f"{plan.splits} {rounding} w_zp={kw['w_zp']} "
                 f"{kw['out_dtype']}{' A+1' if i % 3 == 1 else ''}")
        cases.append(("qmatmul_exact",
                      lambda a=a, b=b, ep=ep, kw=kw:
                      K.qmatmul_exact(a, b, *ep, **kw),
                      lambda a=a, b=b, ep=ep, kw=kw:
                      K.qmatmul_plain(a, b, *ep, **kw), label))
        mult = t((30.0 / (np.sqrt(k) * 73.0 * 73.0) * rng.uniform(
            0.5, 2.0, n if i % 4 < 2 else 1)).astype(np.float32))
        fkw = dict(kw)
        del fkw["rounding"]
        cases.append(("qmatmul_fast",
                      lambda a=a, b=b, ep=ep, mult=mult, fkw=fkw:
                      K.qmatmul_fast(a, b, ep[0], mult, **fkw),
                      lambda a=a, b=b, ep=ep, mult=mult, fkw=fkw:
                      K.qmatmul_fast_plain(a, b, ep[0], mult, **fkw), label))
    # split-K with wrapping sums: 49 x 160 x 960 splits K over 8 blocks
    m, k, n = 49, 960, 160
    a, b = i8(m, k), i8(k, n)
    big = rng.integers(0, 5000, n)
    bias = t(np.where(np.arange(n) % 2 == 1, 2 ** 31 - 1 - big,
                      -(2 ** 31) + big).astype(np.int32))
    qm, sh = Q.quantize_multipliers(2.0 ** -24 * rng.uniform(0.5, 1.5, n))
    mult = t((2.0 ** -24 * rng.uniform(0.5, 1.5, n)).astype(np.float32))
    for w_zp in (0, 5):
        kw = out_args(torch.int8, "double", w_zp)
        label = f"M{m} K{k} N{n} bias near +-2^31 w_zp={w_zp}"
        cases.append(("qmatmul_exact",
                      lambda kw=kw: K.qmatmul_exact(a, b, bias, t(qm), t(sh),
                                                    **kw),
                      lambda kw=kw: K.qmatmul_plain(a, b, bias, t(qm), t(sh),
                                                    **kw), label))
        fkw = dict(kw)
        del fkw["rounding"]
        cases.append(("qmatmul_fast",
                      lambda fkw=fkw: K.qmatmul_fast(a, b, bias, mult, **fkw),
                      lambda fkw=fkw: K.qmatmul_fast_plain(a, b, bias, mult,
                                                           **fkw), label))
    return cases


def dwconv_plan_cases(torch, K, rng, i8, epilogue, out_args):
    """Both depthwise kernels (B3 and its fast instance) on every branch
    of dwconv_plan and on every variant of the strip kernel: ragged C (7,
    13, 33), depth multiplier 3 (C*mult = 5x3), 5x5, stride (2, 1),
    dilation 2, 3x5 and 1x1 taps, stride 3, more rows than grid z holds,
    x one, four and eight bytes into a buffer (the general loop, then
    word loads), strips of 1, 2 and 4 columns, blocks shrunk for small
    outputs, output widths that no strip divides, w_zp 0 and 3, int8 and
    uint8 outputs in turn; then each variant forced through the plan,
    under each block size in turn, with each w_zp (the kernel's WZP
    template flag) and each output type.  Per-channel and per-tensor
    multipliers in turn."""
    from band_tpu_torch.ops.kernels import qdwconv as QD

    def x_at(n, h, w, c, offset):
        if offset == 0:
            return i8(n, h, w, c)
        return i8(n * h * w * c + offset)[offset:].view(n, h, w, c)

    def same_pads(k, dil=1):
        e = (k - 1) * dil
        return (e // 2, e - e // 2)

    def add(geom, i, plan=None, w_zp=None, od=None):
        n, h, w, c, mult, kh, kw, st, dil, offset = geom
        x = x_at(n, h, w, c, offset)
        co = c * mult
        wk = i8(kh * kw, co)
        od = (torch.int8, torch.uint8)[i % 2] if od is None else od
        w_zp = (0, 3)[(i // 2) % 2] if w_zp is None else w_zp
        rounding = ("single", "double", "ruy")[i % 3]
        ep = epilogue(co, kh * kw, per_channel=i % 4 < 2)
        kw_ = dict(out_args(od, rounding, w_zp), kh=kh, kw=kw, stride=st,
                   dilation=dil, x_zp=-7,
                   padding=(same_pads(kh, dil[0]), same_pads(kw, dil[1])))
        fkw = dict(kw_)
        del fkw["rounding"]
        mult_f = ep[0].new_tensor(  # per channel or per tensor, as qm
            (30.0 / (3.0 * 73.0 * 73.0) * rng.uniform(
                0.5, 2.0, ep[1].numel())).astype(np.float32),
            dtype=torch.float32)
        oh = (h + sum(kw_["padding"][0]) - (kh - 1) * dil[0] - 1) // st[0] + 1
        ow = (w + sum(kw_["padding"][1]) - (kw - 1) * dil[1] - 1) // st[1] + 1
        if plan is None:
            # the wrapper plans the call itself (out is 16-byte aligned)
            what = "plan " + QD.dwconv_plan(n, oh, ow, c, mult, kh, kw, st,
                                            dil, QD.alignment(x, wk)).name

            def forced(f):
                return f
        else:
            plan = plan(n, oh, ow, c)
            what = f"forced {plan.name}"

            def forced(f):
                def g():
                    saved = QD.dwconv_plan
                    QD.dwconv_plan = lambda *a: plan
                    try:
                        return f()
                    finally:
                        QD.dwconv_plan = saved
                return g
        label = (f"dw {n}x{h}x{w}x{c} x{mult} {kh}x{kw} s{st} d{dil} "
                 f"x+{offset} {what} {rounding} w_zp={w_zp} {od}")

        return [("qdwconv2d_exact",
                 forced(lambda: K.qdwconv2d_exact(x, wk, *ep, **kw_)),
                 lambda: K.qdwconv2d_plain(x, wk, *ep, **kw_), label),
                ("qdwconv2d_fast",
                 forced(lambda: K.qdwconv2d_fast(x, wk, ep[0], mult_f,
                                                 **fkw)),
                 lambda: K.qdwconv2d_fast_plain(x, wk, ep[0], mult_f, **fkw),
                 label)]

    geoms = [
        # (n, h, w, c, mult, kh, kw, stride, dilation, x's byte offset)
        (2, 13, 11, 7, 1, 3, 3, (1, 1), (1, 1), 0),      # ragged C: general
        (1, 12, 17, 13, 1, 3, 3, (2, 2), (1, 1), 0),
        (2, 9, 10, 33, 1, 3, 3, (1, 1), (1, 1), 0),
        (2, 11, 12, 5, 3, 3, 3, (1, 1), (1, 1), 0),      # multiplier 3
        (2, 15, 14, 24, 1, 5, 5, (1, 1), (1, 1), 0),     # 5x5
        (1, 16, 15, 40, 1, 5, 5, (2, 2), (1, 1), 0),
        (2, 14, 13, 32, 1, 3, 3, (2, 1), (1, 1), 0),     # stride (2, 1)
        (1, 15, 15, 16, 1, 3, 3, (1, 1), (2, 2), 0),     # dilation 2
        (1, 9, 9, 8, 1, 3, 5, (1, 1), (1, 1), 0),        # 3x5: general
        (2, 7, 7, 16, 1, 1, 1, (1, 1), (1, 1), 0),       # 1x1: general
        (1, 9, 9, 16, 1, 3, 3, (1, 3), (1, 1), 0),       # stride 3: general
        (1, 65540, 1, 4, 1, 3, 3, (1, 1), (1, 1), 0),    # n*oh > grid z
        (2, 17, 19, 48, 1, 3, 3, (1, 1), (1, 1), 1),     # x + 1: general
        (2, 17, 19, 48, 1, 3, 3, (2, 2), (1, 1), 4),     # x + 4: v4
        (2, 17, 19, 48, 1, 3, 3, (1, 1), (1, 1), 8),     # x + 8: v4
        (8, 56, 56, 144, 1, 3, 3, (1, 1), (1, 1), 0),    # strips of 4
        (1, 28, 28, 192, 1, 3, 3, (1, 1), (1, 1), 0),    # strips of 2
        (1, 7, 7, 960, 1, 3, 3, (1, 1), (1, 1), 0),      # 1, small blocks
        (1, 14, 14, 576, 1, 3, 3, (2, 2), (1, 1), 0),
    ]
    cases = []
    i = 0
    for geom in geoms:
        cases += add(geom, i)
        i += 1
    for v, (kh, sw, _) in enumerate(QD.VARIANTS):
        t = (32, 64, 128, QD.MAX_THREADS)[v % 4]
        geom = (2, 13, 11, 3 * QD.VEC, 1, kh, kh, (1 + v % 2, sw), (1, 1), 0)
        for w_zp in (0, 3):
            for od in (torch.int8, torch.uint8):
                cases += add(geom, i, lambda n, oh, ow, c, v=v, t=t:
                             QD.strip_plan(v, n, oh, ow, c, t), w_zp, od)
                i += 1
    return cases


def forced(module, name, value):
    """Wrap a thunk so that it runs with ``module.<name>`` returning
    ``value`` (a plan) for every call."""
    def wrap(f):
        def g():
            saved = getattr(module, name)
            setattr(module, name, lambda *a: value)
            try:
                return f()
            finally:
                setattr(module, name, saved)
        return g
    return wrap


def conv_plan_cases(torch, K, rng, i8, epilogue, out_args):
    """Both convs (B2 and its fast instance) on every branch of conv_plan:
    its own plan on stems and small-Ci convs (Ci 1, 3, 8, 16; stride 1
    and 2; Oc 16 to 64; x one byte into a buffer) and on shapes that take
    the general loop (Oc 70, 5x5 with Oc 9); then on geometries that
    reach every compiled instance (1, 2 and 4 words per pixel; 3x3 and
    other taps) each direct variant forced onto a ragged 2x4 tile and
    the general loop forced, each with w_zp 0 and 3 and int8 and uint8
    outputs.
    Per-channel and per-tensor multipliers in turn."""
    from band_tpu_torch.ops.kernels import qconv as QC

    def add(geom, i, plan=None, w_zp=None, od=None):
        n, h, w, ci, oc, kh, kw, st, pad, offset = geom
        x = (i8(n, h, w, ci) if offset == 0 else
             i8(n * h * w * ci + offset)[offset:].view(n, h, w, ci))
        wk = i8(kh * kw * ci, oc)
        od = (torch.int8, torch.uint8)[i % 2] if od is None else od
        w_zp = (0, 3)[(i // 2) % 2] if w_zp is None else w_zp
        rounding = ("single", "double", "ruy")[i % 3]
        ep = epilogue(oc, kh * kw * ci, per_channel=i % 4 < 2)
        kw_ = dict(out_args(od, rounding, w_zp), kh=kh, kw=kw, stride=st,
                   dilation=(1, 1), padding=pad, x_zp=-7)
        fkw = dict(kw_)
        del fkw["rounding"]
        mult = ep[0].new_tensor(
            (30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0) * rng.uniform(
                0.5, 2.0, ep[1].numel())).astype(np.float32),
            dtype=torch.float32)
        oh = (h + sum(pad[0]) - kh) // st[0] + 1
        ow = (w + sum(pad[1]) - kw) // st[1] + 1
        if plan is None:
            what = "plan " + QC.conv_plan(n, oh, ow, ci, oc, kh, kw, st,
                                          (1, 1), QC.alignment(wk)).name
            wrap = (lambda f: f)
        else:
            plan = plan(n, oh, ow, ci, oc, kh, kw, st)
            what = f"forced {plan.name}"
            wrap = forced(QC, "conv_plan", plan)
        label = (f"conv {n}x{h}x{w}x{ci} oc{oc} {kh}x{kw} s{st} x+{offset} "
                 f"{what} {rounding} w_zp={w_zp} {od}")
        return [("qconv2d_exact",
                 wrap(lambda: K.qconv2d_exact(x, wk, *ep, **kw_)),
                 lambda: K.qconv2d_plain(x, wk, *ep, **kw_), label),
                ("qconv2d_fast",
                 wrap(lambda: K.qconv2d_fast(x, wk, ep[0], mult, **fkw)),
                 lambda: K.qconv2d_fast_plain(x, wk, ep[0], mult, **fkw),
                 label)]

    same = ((1, 1), (1, 1))
    s2 = ((0, 1), (0, 1))
    geoms = [
        # (n, h, w, ci, oc, kh, kw, stride, padding, x's byte offset)
        (1, 30, 28, 3, 32, 3, 3, (2, 2), s2, 0),        # stems
        (2, 20, 20, 3, 16, 3, 3, (2, 2), s2, 1),
        (2, 12, 13, 3, 16, 3, 3, (1, 1), same, 0),
        (2, 9, 11, 1, 8, 3, 3, (2, 2), s2, 0),
        (2, 10, 9, 8, 16, 3, 3, (1, 1), same, 0),       # small Ci
        (1, 9, 10, 16, 16, 3, 3, (1, 1), same, 4),
        (1, 9, 10, 16, 64, 3, 3, (2, 2), s2, 0),
        (2, 11, 10, 5, 24, 5, 5, (1, 2), ((2, 2), (2, 2)), 0),
        (1, 9, 9, 16, 70, 3, 3, (1, 1), same, 0),       # general
        (2, 12, 12, 5, 9, 5, 5, (1, 2), ((2, 2), (1, 2)), 0),
        (1, 10, 11, 3, 16, 3, 5, (1, 1), ((1, 1), (2, 2)), 0),
        (1, 9, 8, 16, 16, 5, 3, (2, 1), ((2, 2), (1, 1)), 1),
    ]
    cases = []
    i = 0
    for geom in geoms:
        cases += add(geom, i)
        i += 1
    # every instance: 1, 2 and 4 words per pixel, 3x3 and other taps
    for geom in (geoms[1], geoms[4], geoms[5], geoms[7], geoms[10],
                 geoms[11]):
        plans = [lambda n, oh, ow, ci, oc, kh, kw, st: QC.general_plan(
            n, oh, ow, oc)]
        plans += [lambda n, oh, ow, ci, oc, kh, kw, st, v=v: QC.direct_plan(
            v, n, oh, ow, ci, oc, kh, kw, st, (1, 1), 2, 4)
            for v in range(len(QC.DIRECT_VARIANTS))]
        for plan in plans:
            for w_zp in (0, 3):
                for od in (torch.int8, torch.uint8):
                    cases += add(geom, i, plan, w_zp, od)
                    i += 1
    return cases


def softmax_plan_cases(torch, K, Q, rng, t):
    """lut_softmax on every branch of softmax_plan: its own plan, the
    thread kernel and the row kernel (32, 64 and 256 threads) forced, on
    1 and 8 rows of depth 10, 1000 and 1001, int8 and uint8 in and out,
    x at offset 0 and 1 from alignment."""
    from band_tpu_torch.ops.kernels import softmax as SM

    cases = []
    table = t(Q.softmax_table(0.05, 1.0))
    for rows in (1, 8):
        for depth in (10, 1000, 1001):
            for in_dtype, od, offset in ((np.int8, torch.int8, 0),
                                         (np.uint8, torch.uint8, 1),
                                         (np.int8, torch.uint8, 1),
                                         (np.uint8, torch.int8, 0)):
                info = np.iinfo(in_dtype)
                buf = t(rng.integers(info.min, info.max + 1,
                                     rows * depth + offset).astype(in_dtype))
                x = buf[offset:].view(rows, depth)
                zp = -128 if od == torch.int8 else 0
                plans = [None, SM.thread_plan(rows)] + [
                    SM.row_plan(rows, depth, n) for n in (32, 64, 256)]
                for plan in plans:
                    what = ("plan " + SM.softmax_plan(rows, depth).name
                            if plan is None else f"forced {plan.name}")
                    wrap = ((lambda f: f) if plan is None
                            else forced(SM, "softmax_plan", plan))
                    cases.append((
                        "lut_softmax",
                        wrap(lambda x=x, zp=zp, od=od:
                             K.lut_softmax(x, table, 1.0 / 256, zp, od)),
                        lambda x=x, zp=zp, od=od:
                        K.lut_softmax_plain(x, table, 1.0 / 256, zp, od),
                        f"softmax rows {rows} depth {depth} x+{offset} "
                        f"{what} {in_dtype.__name__} -> {od}"))
    return cases


def fast_synthetic_cases(torch, K, rng, t, i8, out_args):
    """The fast kernels' synthetic cases: per-tensor and per-channel mult,
    w_zp 0 and != 0, int8 and uint8 outputs, ragged K, mult 0.5 on odd
    sums (exact ties, rounded to even), and sums above 2^24 (where the
    int32 -> float32 conversion itself rounds)."""
    def fast_args(od, w_zp):
        kw = out_args(od, "ruy", w_zp)
        del kw["rounding"]
        return kw

    def mult(n, k, per_channel, value=None):
        if value is None:
            # map the accumulator's spread to ~30 units
            m = (30.0 / max(np.sqrt(k) * 73.0 * 73.0, 1.0)
                 * rng.uniform(0.5, 2.0, n))
        else:
            m = np.full(n, value)
        m = m.astype(np.float32)
        return t(m if per_channel else m[:1])

    def bias(n):
        return t(rng.integers(-20000, 20000, n).astype(np.int32))

    def pair(name, args, kw, label):
        kern, plain = getattr(K, name), getattr(K, name + "_plain")
        return (name, lambda: kern(*args, **kw), lambda: plain(*args, **kw),
                label)

    cases = []
    for w_zp in (0, 7):
        for od in (torch.int8, torch.uint8):
            for per_channel in (False, True):
                for m, k, n in ((200, 96, 72), (33, 27, 10)):
                    a, b = i8(m, k), i8(k, n)
                    for value in (None, 0.5):
                        cases.append(pair(
                            "qmatmul_fast",
                            (a, b, bias(n), mult(n, k, per_channel, value)),
                            fast_args(od, w_zp),
                            f"M{m} K{k} N{n} mult={value or 'spread'} "
                            f"per_channel={per_channel} w_zp={w_zp} {od}"))
    # every sum above 2^24: constant operands 120 x 110 over K = 1536
    a = t(np.full((40, 1536), 120, np.int8))
    b = t(np.full((1536, 8), 110, np.int8))
    for per_channel in (False, True):
        cases.append(pair("qmatmul_fast",
                          (a, b, bias(8), mult(8, 0, per_channel, 2e-6)),
                          fast_args(torch.int8, 0),
                          f"sums 2.03e7 > 2^24 per_channel={per_channel}"))
    for i, (st, dil, pad) in enumerate((((1, 1), (1, 1), ((1, 1), (1, 1))),
                                        ((2, 2), (1, 1), ((0, 1), (0, 1))),
                                        ((1, 1), (2, 2), ((2, 2), (2, 2))))):
        od = (torch.int8, torch.uint8)[i % 2]
        for w_zp in (0, -5):
            ci, oc = (3, 8, 16)[i], 24
            x, wk = i8(2, 13, 12, ci), i8(9 * ci, oc)
            kw = dict(fast_args(od, w_zp), kh=3, kw=3, stride=st,
                      dilation=dil, padding=pad, x_zp=-9)
            cases.append(pair("qconv2d_fast",
                              (x, wk, bias(oc), mult(oc, 9 * ci, i != 1)),
                              kw, f"3x3 ci{ci} s{st} d{dil} w_zp={w_zp} {od}"))
            c, dm = (32, 12, 16)[i], (1, 2, 1)[i]
            x, wd = i8(2, 11, 13, c), i8(9, c * dm)
            kw = dict(fast_args(od, w_zp), kh=3, kw=3, stride=st,
                      dilation=dil, padding=pad, x_zp=11)
            cases.append(pair("qdwconv2d_fast",
                              (x, wd, bias(c * dm),
                               mult(c * dm, 9, i != 2, 0.5 if i else None)),
                              kw, f"c{c} x{dm} s{st} d{dil} w_zp={w_zp} {od}"))
    return cases


def kernel_phase(torch, dev, graphs, goldens):
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L
    from band_tpu_torch.ops import quant as Q

    plain = {"qmatmul_exact": K.qmatmul_plain,
             "qconv2d_exact": K.qconv2d_plain,
             "qdwconv2d_exact": K.qdwconv2d_plain,
             "lut_softmax": K.lut_softmax_plain,
             "qmatmul_fast": K.qmatmul_fast_plain,
             "qconv2d_fast": K.qconv2d_fast_plain,
             "qdwconv2d_fast": K.qdwconv2d_fast_plain}
    worst = {n: 0 for n in KERNELS}

    # synthetic cases
    for name, kern, ref, label in synthetic_cases(torch, K, Q, dev):
        got, want = kern(), ref()
        torch.cuda.synchronize()
        worst[name] = max(worst[name], same(torch, name, got, want, label))
    log("kernels: synthetic cases byte-equal to plain (tolerance 0)")

    # every call of a full-width MobileNetV2 request, at b1 and b8, with
    # exact and with fast numerics
    g = graphs[FULL_WIDTH]
    xs = goldens[FULL_WIDTH]["xs"]
    per_b = {1: [], MAX_BATCH: []}
    with torch.inference_mode():
        for exact in (True, False):
            prog = build_program(g, range(len(g.ops)), exact=exact)
            params = params_from_jax(prog.params, dev)
            fn = prog.make_fn()
            what = "exact" if exact else "fast"
            for b in (1, MAX_BATCH):
                x = torch.from_numpy(np.concatenate(list(xs[:b]))).to(dev)
                calls = capture_calls(L, fn, params, [x])
                torch.cuda.synchronize()
                for name, args, kw, out in calls:
                    want = plain[name](*args, **kw)
                    torch.cuda.synchronize()
                    worst[name] = max(worst[name], same(
                        torch, name, out, want,
                        f"MobileNetV2 {what} b{b} {tuple(args[0].shape)}"))
                check(not any(n in (EXACT_ONLY if not exact else FAST)
                              for n, *_ in calls),
                      f"MobileNetV2 {what}: a kernel of the other numerics")
                per_b[b] += calls
                log(f"kernels: MobileNetV2 {what} b{b}: {len(calls)} calls "
                    f"byte-equal to plain (tolerance 0)")

        # (lut_softmax's b1 call is the same in both numerics: timed once)
        stats = {n: dict(launches_b1=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         bytes_s=0.0, ops_s=0.0, library_ms=None)
                 for n in KERNELS}
        softmax_calls = [c for c in per_b[1] if c[0] == "lut_softmax"]
        per_b[1] = [c for c in per_b[1] if c[0] != "lut_softmax"] + \
            softmax_calls[:1]
        wrapper = {n: getattr(K, n) for n in KERNELS}
        gemms = {}  # (M, N, K) -> calls and times of one call
        dwconvs = {}  # (input shape, stride) -> plan, calls, times
        for name, args, kw, out in per_b[1]:
            s = stats[name]
            s["launches_b1"] += 1
            ms = graph_ms(torch, lambda: wrapper[name](*args, **kw))
            s["ms"] += ms
            s["plain_ms"] += eager_ms(torch, lambda: plain[name](*args, **kw))
            nbytes, ops, rate = work(name, args, kw, out)
            bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate
            s["bytes_s"] += bt
            s["ops_s"] += ot
            s["bound_ms"] += max(bt, ot)
            if name in ("qmatmul_exact", "qmatmul_fast"):
                a, b = args[0], args[1]
                shape = (a.shape[0], b.shape[1], a.shape[1])
                if a.shape[0] <= 16:
                    # torch._int_mm takes more than 16 rows: zero rows pad
                    pad = torch.zeros((32, a.shape[1]), dtype=a.dtype,
                                      device=dev)
                    pad[: a.shape[0]] = a
                    a = pad
                # cuBLASLt's int8 GEMM takes B column-major (TN layout)
                b = b.t().contiguous().t()
                lib = graph_ms(torch, lambda a=a, b=b: torch._int_mm(a, b))
                s["library_ms"] = (s["library_ms"] or 0.0) + lib
                g = gemms.setdefault(shape, dict(
                    calls=0, qmatmul_exact=[], qmatmul_fast=[], int_mm=[],
                    bound_ms=max(bt, ot)))
                g["calls"] += name == "qmatmul_exact"
                g[name].append(ms)
                g["int_mm"].append(lib)
            if name in ("qconv2d_exact", "qconv2d_fast"):
                lib = graph_ms(torch, conv_library(torch, dev, args, kw,
                                                   depthwise=False))
                s["library_ms"] = (s["library_ms"] or 0.0) + lib
            if name == "lut_softmax":
                lib = graph_ms(torch, softmax_library(torch, args))
                s["library_ms"] = (s["library_ms"] or 0.0) + lib
            if name in ("qdwconv2d_exact", "qdwconv2d_fast"):
                lib = graph_ms(torch, conv_library(torch, dev, args, kw,
                                                   depthwise=True))
                s["library_ms"] = (s["library_ms"] or 0.0) + lib
                x = args[0]
                d = dwconvs.setdefault((tuple(x.shape), tuple(kw["stride"])),
                                       dict(calls=0, qdwconv2d_exact=[],
                                            qdwconv2d_fast=[], library=[],
                                            bound_ms=max(bt, ot),
                                            plan=dwconv_plan_of(args, kw,
                                                                out)))
                d["calls"] += name == "qdwconv2d_exact"
                d[name].append(ms)
                d["library"].append(lib)
        mean = lambda v: sum(v) / len(v)  # noqa: E731
        for (m, n, k), g in sorted(gemms.items(), key=lambda kv: -kv[0][0]):
            p = K.gemm_plan(m, n, k)
            log("gemm: " + json.dumps({
                "M": m, "N": n, "K": k, "calls_b1": g["calls"],
                "tile": f"{p.bm}x{p.bn}", "splits": p.splits,
                "blocks": p.blocks,
                "exact_ms": mean(g["qmatmul_exact"]),
                "fast_ms": mean(g["qmatmul_fast"]),
                "int_mm_ms": mean(g["int_mm"]), "bound_ms": g["bound_ms"]}))
        for (shape, stride), d in sorted(dwconvs.items(),
                                         key=lambda kv: -np.prod(kv[0][0])):
            p = d["plan"]
            log("dwconv: " + json.dumps({
                "shape": "x".join(map(str, shape)), "stride": list(stride),
                "calls_b1": d["calls"], "plan": p.name,
                "threads": p.grid[0] * p.grid[1] * p.grid[2] * p.threads,
                "exact_ms": mean(d["qdwconv2d_exact"]),
                "fast_ms": mean(d["qdwconv2d_fast"]),
                "library_ms": mean(d["library"]), "bound_ms": d["bound_ms"]}))
        # the per-launch floor of the timing harness
        z = torch.zeros(1, device=dev)
        floor = graph_ms(torch, lambda: z.add_(1))
        log(f"launch floor: one trivial PyTorch kernel {floor:.6f} ms in the "
            f"same CUDA-graph harness; x35 = {35 * floor:.6f} ms")
    return worst, stats


def model_calls(torch, dev, graphs, xs, names, exact, batch):
    """Every kernel call of one run of each model in ``names`` at
    ``batch`` (its golden inputs), with exact or fast numerics, from the
    port's program on the card."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import lowerings as L

    calls = []
    for name in names:
        g = graphs[name]
        prog = build_program(g, range(len(g.ops)), exact=exact)
        params = params_from_jax(prog.params, dev)
        x = torch.from_numpy(np.concatenate(list(xs[name][:batch]))).to(dev)
        calls += capture_calls(L, prog.make_fn(), params, [x])
    torch.cuda.synchronize()
    return calls


def bound_ms(name, args, kw, out):
    nbytes, ops, rate = work(name, args, kw, out)
    return max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate)


def conv_softmax_lines(torch, dev, graphs, goldens, fast_goldens, sm_ghz):
    """One ``qconv:`` line per distinct B2 shape and one ``softmax:`` line
    per distinct SOFTMAX shape of the slice models, at b1 and b8, from
    their real calls on the card: the plan and its times beside the other
    branches forced (for B2 the general implicit-GEMM loop, the parent
    commit's kernel; for the softmax the thread and the row kernel), the
    yardstick, the bound, and for the softmax the serial floor: depth
    dependent float32 adds at FADD_CYCLES each, at the card's top SM
    clock."""
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops.kernels import qconv as QC
    from band_tpu_torch.ops.kernels import softmax as SM

    xs = {n: goldens[n]["xs"] for n in MODELS}
    xs[QUANT_ACT] = fast_goldens[QUANT_ACT]["xs"]
    names = MODELS + (QUANT_ACT,)
    with torch.inference_mode():
        for b in (1, MAX_BATCH):
            calls = (model_calls(torch, dev, graphs, xs, names, True, b)
                     + model_calls(torch, dev, graphs, xs, names, False, b))
            convs, softmaxes = {}, {}
            for name, args, kw, out in calls:
                if name in ("qconv2d_exact", "qconv2d_fast"):
                    x, w = args[0], args[1]
                    key = (tuple(x.shape), w.shape[1], tuple(kw["stride"]),
                           tuple(tuple(p) for p in kw["padding"]))
                    d = convs.setdefault(key, dict(calls=0))
                    d["calls"] += name == "qconv2d_exact"
                    d.setdefault(name, (args, kw, out))
                if name == "lut_softmax":
                    d = softmaxes.setdefault(tuple(args[0].shape),
                                             dict(calls=0))
                    d["calls"] += 1
                    d.setdefault("call", (args, kw, out))
            for (shape, oc, stride, pad), d in sorted(
                    convs.items(), key=lambda kv: -np.prod(kv[0][0])):
                args, kw, out = d["qconv2d_exact"]
                fargs, fkw, _ = d["qconv2d_fast"]
                n, h, w, ci = shape
                plan = QC.conv_plan(n, out.shape[1], out.shape[2], ci, oc,
                                    kw["kh"], kw["kw"], stride,
                                    tuple(kw["dilation"]),
                                    QC.alignment(args[1]))
                general = QC.general_plan(n, out.shape[1], out.shape[2], oc)
                exact = lambda: K.qconv2d_exact(*args, **kw)  # noqa: E731
                fast = lambda: K.qconv2d_fast(*fargs, **fkw)  # noqa: E731
                gen = forced(QC, "conv_plan", general)
                log("qconv: " + json.dumps({
                    "shape": "x".join(map(str, shape)), "oc": oc,
                    "stride": list(stride), "batch": b,
                    "calls": d["calls"], "plan": plan.name,
                    "blocks": plan.blocks, "threads": plan.threads,
                    "exact_ms": graph_ms(torch, exact),
                    "fast_ms": graph_ms(torch, fast),
                    "general_exact_ms": graph_ms(torch, gen(exact)),
                    "general_fast_ms": graph_ms(torch, gen(fast)),
                    "library_ms": graph_ms(torch, conv_library(
                        torch, dev, args, kw, depthwise=False)),
                    "bound_ms": bound_ms("qconv2d_exact", args, kw, out)}))
            for shape, d in sorted(softmaxes.items(),
                                   key=lambda kv: -np.prod(kv[0])):
                args, kw, out = d["call"]
                depth = shape[-1]
                rows = int(np.prod(shape)) // depth
                plan = SM.softmax_plan(rows, depth)
                run = lambda: K.lut_softmax(*args, **kw)  # noqa: E731
                log("softmax: " + json.dumps({
                    "shape": list(shape), "batch": b,
                    "calls": d["calls"] // 2, "plan": plan.name,
                    "plan_ms": graph_ms(torch, run),
                    "thread_ms": graph_ms(torch, forced(
                        SM, "softmax_plan", SM.thread_plan(rows))(run)),
                    "row_ms": graph_ms(torch, forced(
                        SM, "softmax_plan", SM.row_plan(rows, depth))(run)),
                    "library_ms": graph_ms(torch,
                                           softmax_library(torch, args)),
                    "bound_ms": bound_ms("lut_softmax", args, kw, out),
                    "serial_floor_ms": depth * FADD_CYCLES / (sm_ghz * 1e6),
                }))


# --------------------------------------------------------------------------
# engine and depth phases
# --------------------------------------------------------------------------

def _engine(bt, flag, numerics):
    return bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=flag, device_ids=(0,),
                                  max_batch=MAX_BATCH))
        .numerics(numerics)
        .build())


def _same_outputs(outs, want, i, what):
    """Check one request's outputs against the goldens' request i."""
    check(len(outs) == len(want) and all(
        np.array_equal(o, w[i]) for o, w in zip(outs, want)),
        f"{what} request {i}: output differs from the golden")


def engine_phase(torch, bt, K, models, goldens, card, flag, numerics):
    """Serve ``models`` through one engine with ``numerics`` engine-wide;
    returns (launch counts of this phase, rates by model)."""
    K.reset_launches()
    eng = _engine(bt, flag, numerics)
    phase = "engine" if numerics == "exact" else "fast"
    rates = {}
    try:
        mids = {}
        t0 = time.perf_counter()
        for name in models:
            mids[name] = eng.register_model(
                bt.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
        check(eng.wait_buckets_ready(timeout=600), "bucket warm-up timed out")
        log(f"{phase}: {len(models)} models registered ({numerics} "
            f"numerics) and buckets 2..{MAX_BATCH} warm in "
            f"{time.perf_counter() - t0:.2f} s")
        for name in models:
            mid, gd = mids[name], goldens[name]
            xs, want = gd["xs"], gd["output"]
            n = len(xs)
            what = f"{phase}: {name}"
            for i in range(SYNC_CHECKED):
                _same_outputs(eng.request_sync(mid, [xs[i]]), want, i,
                              f"{what} sync")
            t0 = time.perf_counter()
            outs = [eng.request_sync(mid, [xs[i % n]])
                    for i in range(SYNC_TIMED)]
            b1 = SYNC_TIMED / (time.perf_counter() - t0)
            for i, o in enumerate(outs):
                _same_outputs(o, want, i % n, f"{what} sync")
            ex = eng.model_record(mid).executors[0]
            check(ex.exact == (numerics == "exact"),
                  f"{what}: executor numerics")
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]]) for i in range(BURST)]
            outs = [eng.wait(j) for j in ids]
            burst = BURST / (time.perf_counter() - t0)
            for i, o in enumerate(outs):
                _same_outputs(o, want, i % n, f"{what} burst")
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"{what}: the burst ran no batch window")
            rates[name] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            log(f"{what}: {SYNC_CHECKED + SYNC_TIMED} sync and "
                f"{BURST} burst outputs byte-equal to the golden; b1 "
                f"{b1:.1f} req/s, burst {burst:.1f} req/s, windows "
                f"{dict(sorted(windows.items()))} ({card})")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    ran, idle = ((EXACT_ONLY + ("lut_softmax",), FAST) if numerics == "exact"
                 else (FAST + ("lut_softmax",), EXACT_ONLY))
    for name in ran:
        check(counts[name] > 0,
              f"{phase}: kernel {name} never launched on the main path")
    for name in idle:
        check(counts[name] == 0,
              f"{phase}: kernel {name} launched with {numerics} numerics")
    log(f"{phase}: launches {json.dumps(counts)}")
    return counts, rates


def mixed_phase(bt, K, goldens, fast_goldens, flag):
    """One engine, default exact numerics: MobileNetV2 and quant_act_int8
    registered twice each, once with numerics="fast", served
    interleaved.  Exact models give the TFLite goldens, fast models the
    fast goldens."""
    K.reset_launches()
    eng = _engine(bt, flag, "exact")
    try:
        served = []  # (model id, inputs, expected outputs, label)
        for name in (FULL_WIDTH, QUANT_ACT):
            path = os.path.join(DATA, f"{name}.tflite")
            fg = fast_goldens[name]
            # quant_act_int8's TFLite goldens sit in the fast goldens
            ex = goldens.get(name, dict(xs=fg["xs"], output=fg.get("exact")))
            served.append((eng.register_model(bt.Model.from_path(path)),
                           ex["xs"], ex["output"], f"{name} exact"))
            served.append((eng.register_model(bt.Model.from_path(path),
                                              numerics="fast"),
                           fg["xs"], fg["output"], f"{name} fast"))
        for mid, _, _, label in served:
            check(eng.model_record(mid).executors[0].exact
                  == label.endswith("exact"), f"mixed: {label} numerics")
        check(eng.wait_buckets_ready(timeout=600), "bucket warm-up timed out")
        n = len(served[0][1])
        pending = []
        for r in range(2 * n):  # interleaved: one request of each in turn
            for mid, xs, want, label in served:
                pending.append((eng.request_async(mid, [xs[r % n]]), want,
                                r % n, label))
        for j, want, i, label in pending:
            _same_outputs(eng.wait(j), want, i, f"mixed: {label}")
        sync = [(eng.request_sync(mid, [xs[0]]), want, label)
                for mid, xs, want, label in served]
        for outs, want, label in sync:
            _same_outputs(outs, want, 0, f"mixed: {label} sync")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    for name in KERNELS:
        check(counts[name] > 0, f"mixed: kernel {name} never launched")
    log(f"mixed: {len(pending) + len(sync)} interleaved requests of "
        f"{len(served)} models (exact and fast side by side) byte-equal to "
        f"their goldens; launches {json.dumps(counts)}")
    return counts


def depth_phase(torch, dev, graphs, goldens, fast_goldens):
    """Logits below the SOFTMAX of each model, from the program on the
    card, b1 and stacked b8, against the golden logits; and the fast
    program below the first MEAN against band_tpu's fast output."""
    from band_tpu_torch.backend.executor import ModelExecutor

    def run(ex, key, xs, want, what):
        pos = 0
        one = ex.execute(key, [xs[0]])[pos].cpu().numpy()
        check(np.array_equal(one, want[0]), f"{what} at b1")
        many = ex.execute_batched(key, [[x] for x in xs])
        for i, t in enumerate(many):
            check(np.array_equal(t[pos].cpu().numpy(), want[i]),
                  f"{what} at b{len(xs)}, request {i}")

    for name in MODELS:
        g, gd = graphs[name], goldens[name]
        ex = ModelExecutor(-1, g, 0, dev)
        key = ex.prepare_subgraph(range(len(g.ops) - 1), [0])
        check(ex.output_ids(key) == (gd["logits_tid"],),
              f"{name}: the logits are not the program's output")
        run(ex, key, list(gd["xs"]), gd["logits"], f"depth: {name} logits")
        fg = fast_goldens[name]
        fex = ModelExecutor(-1, g, 0, dev, exact=False)
        fkey = fex.prepare_subgraph(fg["seg0_ops"], [0])
        check(len(fex.output_ids(fkey)) == 1,
              f"{name}: the fast segment has more than one output")
        run(fex, fkey, list(fg["xs"]), fg["seg0"],
            f"depth: {name} fast segment")
        log(f"depth: {name}: logits byte-equal to the golden and the fast "
            f"program below the first MEAN (ops {fg['seg0_ops'].start}-"
            f"{fg['seg0_ops'].stop - 1}) byte-equal to band_tpu's at b1 "
            f"and b{len(gd['xs'])} ({len(np.unique(gd['logits']))} and "
            f"{len(np.unique(fg['seg0']))} distinct values)")


def profile_phase(torch, dev, graphs, goldens, exact):
    """Where a b1 MobileNetV2 request's time goes below the engine: the
    executor's wall time per request (launch and wait), and the device
    time of every kernel it launches (torch.profiler), whose ratio is
    the device's busy share."""
    from band_tpu_torch.backend.executor import ModelExecutor

    g = graphs[FULL_WIDTH]
    x = goldens[FULL_WIDTH]["xs"][0]
    ex = ModelExecutor(-2, g, 0, dev, exact=exact)
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    reps = 20
    for _ in range(3):
        ex.execute(key, [x])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ex.execute(key, [x])
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            ex.execute(key, [x])
            torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = (e.self_device_time_total / 1e3 / reps,
                                e.count // reps)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    out = {
        "model": FULL_WIDTH, "batch": 1,
        "numerics": "exact" if exact else "fast",
        "executor_wall_ms": wall_ms,
        "device_kernel_ms": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": (device_ms / wall_ms if device_ms > 0
                              else "not measured"),
        "launches": sum(n for _, n in by_kernel.values()),
        "top_kernels_ms": {k[:60]: ms for k, (ms, _) in top},
    }
    log("profile: " + json.dumps(out))
    return out


# --------------------------------------------------------------------------

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import band_tpu_torch as bt
    except ImportError as e:
        print(f"chip_smoke: band_tpu_torch not found beside the script ({e})",
              file=sys.stderr)
        return 2
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops.kernels import build
    from band_tpu_torch.tflite.parser import parse_tflite_file

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    log(f"device: top SM clock {sm_mhz:.0f} MHz")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")

    secs = build.build_all(verbose=True)
    log(f"build: {len(build.sources())} kernel libraries in {secs:.1f} s")

    graphs = {n: parse_tflite_file(os.path.join(DATA, f"{n}.tflite"))
              for n in FAST_MODELS}
    goldens = load_goldens(graphs)
    fast_goldens = load_fast_goldens(graphs)

    worst, stats = kernel_phase(torch, dev, graphs, goldens)
    conv_softmax_lines(torch, dev, graphs, goldens, fast_goldens,
                       sm_mhz / 1e3)
    counts, rates = engine_phase(torch, bt, K, MODELS, goldens, card,
                                 bt.DeviceFlag.GPU, "exact")
    fast_counts, fast_rates = engine_phase(torch, bt, K, FAST_MODELS,
                                           fast_goldens, card,
                                           bt.DeviceFlag.GPU, "fast")
    mixed_phase(bt, K, goldens, fast_goldens, bt.DeviceFlag.GPU)
    depth_phase(torch, dev, graphs, goldens, fast_goldens)
    profile_phase(torch, dev, graphs, goldens, exact=True)
    profile_phase(torch, dev, graphs, goldens, exact=False)

    log("engine: " + json.dumps({"card": smi, "numerics": "exact",
                                 "models": rates}))
    log("fast: " + json.dumps({"card": smi, "numerics": "fast",
                               "models": fast_rates}))
    line = []
    for name, meta in KERNELS.items():
        s = stats[name]
        # each kernel's launches on its own main path: the exact kernels
        # in the exact engine phase, the fast ones in the fast phase
        launched = fast_counts if name in FAST else counts
        line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launched[name],
            "max_abs_err": worst[name],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_s"] >= s["ops_s"] else "operations",
            "library_ms": s["library_ms"],
            "mobilenet_v2_b1_launches": s["launches_b1"],
        })
    log(json.dumps({"kernels": line}))
    log(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
