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
               b1 and at b8 (captured from the model's program run on
               the card, real weights and activations);
             - on synthetic cases: all three roundings, w_zp 0 and != 0,
               int8 and uint8 outputs, ragged K, conv strides 1/2 and
               dilation 2, depthwise stride 2, dilation 2 and depth
               multiplier 2.
             At MobileNetV2's b1 calls each kernel is timed (a CUDA graph
             of 20 launches, replayed), beside its plain version (eager,
             CUDA events), its bound, and for the int8 GEMM one
             torch._int_mm call per GEMM as a yardstick.
 4. engine   Engine.create with one GPU worker (fixed_worker, max_batch
             8); the full-width MobileNetV2 and the three tests/data CNNs
             registered and served: 4 checked request_sync, 32 timed
             request_sync, then a burst of 32 request_async.  Every
             output is byte-equal to the TFLite golden.  Launch counts
             are zeroed just before this phase and read just after; each
             kernel must have launched.
 5. depth    the logits below each model's SOFTMAX, from the program on
             the card at b1 and stacked b8, byte-equal to the golden
             logits.
 6. profile  a b1 MobileNetV2 request through the executor: its wall
             time, and the device time of its kernels (torch.profiler).
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
FULL_WIDTH = "mobilenet_v2_int8"
MODELS = (FULL_WIDTH, "effnetlite_int8", "resnetish_int8", "fc_int8")
MAX_BATCH = 8
SYNC_CHECKED = 4
SYNC_TIMED = 32
BURST = 32

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

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
}


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


def load_goldens(graphs):
    import hashlib

    z = np.load(GOLDENS)
    out = {}
    for name, g in graphs.items():
        td = g.tensor(g.inputs[0])
        want = z[f"{name}/output"]
        xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype,
                           len(want))
        sha = hashlib.sha256(np.ascontiguousarray(xs).tobytes()).hexdigest()
        check(sha == str(z[f"{name}/input_sha"]),
              f"{name}: regenerated inputs differ from the goldens'")
        out[name] = dict(xs=xs, output=want, logits=z[f"{name}/logits"],
                         logits_tid=int(z[f"{name}/logits_tid"]))
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
    if name == "qmatmul_exact":
        a, b = args[0], args[1]
        m, k = a.shape
        n = b.shape[1]
        nbytes = m * k + k * n + 12 * n + out.numel()
        return nbytes, 2 * m * n * k, INT8_OPS_PER_S
    if name == "qconv2d_exact":
        x, w = args[0], args[1]
        nbytes = x.numel() + w.numel() + 12 * w.shape[1] + out.numel()
        return nbytes, 2 * out.numel() * w.shape[0], INT8_OPS_PER_S
    if name == "qdwconv2d_exact":
        x, w = args[0], args[1]
        nbytes = x.numel() + w.numel() + 12 * w.shape[1] + out.numel()
        return nbytes, 2 * out.numel() * w.shape[0], INT8_OPS_PER_S
    # lut_softmax: a table read, an add, a multiply and a round per
    # element, in float32 outside the tensor cores
    x = args[0]
    return 2 * x.numel() + 4 * 256, 4 * x.numel(), FP32_OPS_PER_S


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------

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
    err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
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


def kernel_phase(torch, dev, graphs, goldens):
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L
    from band_tpu_torch.ops import quant as Q

    plain = {"qmatmul_exact": K.qmatmul_plain,
             "qconv2d_exact": K.qconv2d_plain,
             "qdwconv2d_exact": K.qdwconv2d_plain,
             "lut_softmax": K.lut_softmax_plain}
    worst = {n: 0 for n in KERNELS}

    # synthetic cases
    for name, kern, ref, label in synthetic_cases(torch, K, Q, dev):
        got, want = kern(), ref()
        torch.cuda.synchronize()
        worst[name] = max(worst[name], same(torch, name, got, want, label))
    log("kernels: synthetic cases byte-equal to plain (tolerance 0)")

    # every call of a full-width MobileNetV2 request, at b1 and b8
    g = graphs[FULL_WIDTH]
    prog = build_program(g, range(len(g.ops)))
    params = params_from_jax(prog.params, dev)
    fn = prog.make_fn()
    xs = goldens[FULL_WIDTH]["xs"]
    per_b = {}
    with torch.inference_mode():
        for b in (1, MAX_BATCH):
            x = torch.from_numpy(np.concatenate(list(xs[:b]))).to(dev)
            calls = capture_calls(L, fn, params, [x])
            torch.cuda.synchronize()
            for name, args, kw, out in calls:
                want = plain[name](*args, **kw)
                torch.cuda.synchronize()
                worst[name] = max(worst[name], same(
                    torch, name, out, want,
                    f"MobileNetV2 b{b} {tuple(args[0].shape)}"))
            per_b[b] = calls
            log(f"kernels: MobileNetV2 b{b}: {len(calls)} calls byte-equal "
                f"to plain (tolerance 0)")

        stats = {n: dict(launches_b1=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         bytes_s=0.0, ops_s=0.0, library_ms=None)
                 for n in KERNELS}
        wrapper = {n: getattr(K, n) for n in KERNELS}
        for name, args, kw, out in per_b[1]:
            s = stats[name]
            s["launches_b1"] += 1
            s["ms"] += graph_ms(torch, lambda: wrapper[name](*args, **kw))
            s["plain_ms"] += eager_ms(torch, lambda: plain[name](*args, **kw))
            nbytes, ops, rate = work(name, args, kw, out)
            bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / rate
            s["bytes_s"] += bt
            s["ops_s"] += ot
            s["bound_ms"] += max(bt, ot)
            if name == "qmatmul_exact":
                a, b = args[0], args[1]
                if a.shape[0] <= 16:
                    # torch._int_mm takes more than 16 rows: zero rows pad
                    pad = torch.zeros((32, a.shape[1]), dtype=a.dtype,
                                      device=dev)
                    pad[: a.shape[0]] = a
                    a = pad
                # cuBLASLt's int8 GEMM takes B column-major (TN layout)
                b = b.t().contiguous().t()
                s["library_ms"] = (s["library_ms"] or 0.0) + graph_ms(
                    torch, lambda a=a, b=b: torch._int_mm(a, b))
    return worst, stats


# --------------------------------------------------------------------------
# engine and depth phases
# --------------------------------------------------------------------------

def engine_phase(torch, bt, K, goldens, card, flag):
    K.reset_launches()
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=flag, device_ids=(0,),
                                     max_batch=MAX_BATCH))
           .build())
    eng = bt.Engine.create(cfg)
    rates = {}
    try:
        mids = {}
        t0 = time.perf_counter()
        for name in MODELS:
            mids[name] = eng.register_model(
                bt.Model.from_path(os.path.join(DATA, f"{name}.tflite")))
        check(eng.wait_buckets_ready(timeout=600), "bucket warm-up timed out")
        log(f"engine: 4 models registered and buckets 2..{MAX_BATCH} warm "
            f"in {time.perf_counter() - t0:.2f} s")
        for name in MODELS:
            mid, gd = mids[name], goldens[name]
            xs, want = gd["xs"], gd["output"]
            n = len(xs)

            def expect(i, outs, how):
                check(len(outs) == 1 and np.array_equal(outs[0], want[i]),
                      f"{name} {how} request {i}: output differs from the "
                      "TFLite golden")

            for i in range(SYNC_CHECKED):
                expect(i, eng.request_sync(mid, [xs[i]]), "sync")
            t0 = time.perf_counter()
            outs = [eng.request_sync(mid, [xs[i % n]])
                    for i in range(SYNC_TIMED)]
            b1 = SYNC_TIMED / (time.perf_counter() - t0)
            for i, o in enumerate(outs):
                expect(i % n, o, "sync")
            ex = eng.model_record(mid).executors[0]
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]]) for i in range(BURST)]
            outs = [eng.wait(j) for j in ids]
            burst = BURST / (time.perf_counter() - t0)
            for i, o in enumerate(outs):
                expect(i % n, o, "burst")
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"{name}: the burst ran no batch window")
            rates[name] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            log(f"engine: {name}: {SYNC_CHECKED + SYNC_TIMED} sync and "
                f"{BURST} burst outputs byte-equal to the golden; b1 "
                f"{b1:.1f} req/s, burst {burst:.1f} req/s, windows "
                f"{dict(sorted(windows.items()))} ({card})")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    for name in KERNELS:
        check(counts.get(name, 0) > 0,
              f"kernel {name} never launched on the main path")
    return counts, rates


def depth_phase(torch, dev, graphs, goldens):
    """Logits below the SOFTMAX of each model, from the program on the
    card, b1 and stacked b8, against the golden logits."""
    from band_tpu_torch.backend.executor import ModelExecutor

    for name in MODELS:
        g, gd = graphs[name], goldens[name]
        ex = ModelExecutor(-1, g, 0, dev)
        key = ex.prepare_subgraph(range(len(g.ops) - 1), [0])
        check(ex.output_ids(key) == (gd["logits_tid"],),
              f"{name}: the logits are not the program's output")
        xs = list(gd["xs"])
        one = ex.execute(key, [xs[0]])[0].cpu().numpy()
        check(np.array_equal(one, gd["logits"][0]), f"{name}: b1 logits")
        many = ex.execute_batched(key, [[x] for x in xs])
        for i, t in enumerate(many):
            check(np.array_equal(t[0].cpu().numpy(), gd["logits"][i]),
                  f"{name}: b{len(xs)} logits of request {i}")
        log(f"depth: {name}: logits byte-equal to the golden at b1 and "
            f"b{len(xs)} ({len(np.unique(gd['logits']))} distinct values)")


def profile_phase(torch, dev, graphs, goldens):
    """Where a b1 MobileNetV2 request's time goes below the engine: the
    executor's wall time per request (launch and wait), and the device
    time of every kernel it launches (torch.profiler), whose ratio is
    the device's busy share."""
    from band_tpu_torch.backend.executor import ModelExecutor

    g = graphs[FULL_WIDTH]
    x = goldens[FULL_WIDTH]["xs"][0]
    ex = ModelExecutor(-2, g, 0, dev)
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
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")

    secs = build.build_all(verbose=True)
    log(f"build: {len(build.sources())} kernel libraries in {secs:.1f} s")

    graphs = {n: parse_tflite_file(os.path.join(DATA, f"{n}.tflite"))
              for n in MODELS}
    goldens = load_goldens(graphs)

    worst, stats = kernel_phase(torch, dev, graphs, goldens)
    counts, rates = engine_phase(torch, bt, K, goldens, card,
                                 bt.DeviceFlag.GPU)
    depth_phase(torch, dev, graphs, goldens)
    profile_phase(torch, dev, graphs, goldens)

    log("engine: " + json.dumps({"card": smi, "models": rates}))
    line = []
    for name, meta in KERNELS.items():
        s = stats[name]
        line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": counts[name],
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
