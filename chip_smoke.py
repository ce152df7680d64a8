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
             - on every call the SSD backbones (ssd_int8 and
               ssd_regular_int8 but their detection post-process: the GPU
               workers' part of them in the hetero phase) make at b1, b2
               and b8, exact numerics: 3x3 convs with Ci 3 and 16, 1x1
               head convs with N = 4; and the backbone's output byte-equal
               to TFLite's detector input, every anchor
               (tests/data/torch_hetero_goldens.npz, <name>/head);
             - on synthetic cases: all three roundings, w_zp 0 and != 0,
               int8 and uint8 outputs, ragged K, conv strides 1/2 and
               dilation 2, depthwise stride 2, dilation 2 and depth
               multiplier 2; for both depthwise kernels every branch of
               dwconv_plan and every variant of the strip kernel, each
               with w_zp 0 and != 0 and int8 and uint8 outputs (ragged
               C 7/13/33, multiplier 3, 5x5, stride (2, 1), x one byte
               off alignment, ...); for both convs every branch of
               conv_plan (its own plan on stems and small-Ci convs, the
               mma branch on Ci 56 and 72, Oc 1 to 70, several channel
               groups) and every direct variant, the mma branch with
               each N tile (8, 16, 32) on 128- and 256-pixel tiles and
               qgemm.cuh's loop forced, each with w_zp 0 and != 0 and
               int8 and uint8 outputs; for the softmax every branch of softmax_plan
               (the thread kernel, the row kernel at 32, 64 and 256
               threads) on 1 and 8 rows of depth 10, 1000 and 1001, int8
               and uint8 in and out; for the fast kernels also per-tensor and
               per-channel mult, mult 0.5 on odd sums (ties to even) and
               sums above 2^24; for both GEMMs every branch of gemm_plan
               (M 0..12545, K 16..1280, N 16..1000: each tile, K split or
               not, 16-, 8- and 1-byte copies, A one byte off alignment)
               and a bias near +-2^31 under split-K;
             - on every call of the decoder models (FSRCNN x2 at 360x640
               and at 24x40, tconv_int8, cnn_ops_int8, attention_int8) at
               b1, b8 and in a b32 window, exact and (FSRCNN,
               tconv_int8) fast: each
               TRANSPOSE_CONV's union conv of its sub-pixel phases on
               B2's mma or direct branch, the 1x1 convs on B1; each
               model's outputs equal
               to tests/data/torch_ops_goldens.npz (the digests at full
               width; 0, or the stated quant units of a float-fallback
               output, at the small sizes).
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
             (plan, B2 and B2 fast, both with qgemm.cuh's loop forced,
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
 7. sr       FSRCNN x2 (d=56, s=12, m=4) at its published widths on a
             360x640 frame (tests/data/fsrcnn_x2_int8.tflite), one GPU
             worker (fixed_worker, max_batch 8), registered twice, exact
             and register_model(numerics="fast"): 16 request_sync at b1
             and a burst of 32 request_async in each; every 720x1280
             output's sha256 equal to its golden's (TFLite's exact,
             band_tpu's fast: tests/data/torch_ops_goldens.npz).  Launch
             counts zeroed just before and read just after: B1, B2 and
             their fast instances must launch, no other kernel.  Printed:
             req/s at b1 and in the burst, device time, launches and busy
             share of a b1 request (torch.profiler), and one
             ``qconv_general:`` line per B2 call of a request off the
             direct kernel (the 3x3 12 -> 12 convs and the deconv's union
             conv, which must take the mma branch: checked, and that the
             deconv is one B2 launch a request in each numerics): B2 and
             B2 fast against their plain versions (0 differing bytes),
             the same calls with qgemm.cuh's loop forced, the bound and a
             cuDNN float32 conv of the same shape.
 8. depth    the logits below each model's SOFTMAX, from the program on
             the card at b1 and stacked b8, byte-equal to the golden
             logits; and the fast program's output below the first MEAN,
             byte-equal to band_tpu's fast output stored in the fast
             goldens.
 9. profile  a b1 MobileNetV2 request through the executor, exact and
             fast: its wall time, and the device time of its kernels
             (torch.profiler).
10. hetero   Band's heterogeneous path, laid out as
             configs/benchmark_heft.json: two GPU workers on cuda:0
             (max_batch 8) and one host CPU worker (max_batch 1),
             minimum_subgraph_size 1, merged unit subgraphs, link costs
             probed (the measured table is printed).  Full-width
             MobileNetV2, ssd_int8 and ssd_regular_int8 (whose detection
             post-process is a custom op that runs only on the host
             worker) served under each of fixed_worker_global_queue,
             round_robin, shortest_expected_latency, HEFT, HEFT-reserved
             and least_slack_time_first, one engine each: sync and async
             requests per model (2 + 4 for MobileNetV2; 2 + 2 for each
             SSD model, a burst no wider than the GPU workers), every
             output byte-equal to its golden
             (MobileNetV2: tests/data/torch_goldens.npz; SSD:
             tests/data/torch_hetero_goldens.npz, and within its stated
             box tolerance of the TFLite interpreter).  Printed per
             scheduler: executions per worker (the executors' launch
             sequences) and per model (get_model_execution_counts), and
             where each request's last hop ran (the job records).
             Checked: under SEL, HEFT, HEFT-reserved and LSF every SSD
             request took a GPU -> host hop (its last hop on the host
             worker, fed the backbone's outputs from the card, which are
             byte-equal to TFLite's detector input); the two
             schedulers without fallback subgraphs (round_robin,
             fixed_worker_global_queue) never split a model, so there an
             SSD request runs whole on the host worker; SEL and HEFT keep
             MobileNetV2 on a GPU worker; under LSF a request whose SLO
             no worker can meet ends SLO_VIOLATION.  Every DP call of the
             phase runs in the native plan core and again in the Python
             DP, both under the latency estimator's lock: 0 mismatches.  B1, B2, B3 and lut_softmax must launch in
             this phase.  Also: the host worker's time per MobileNetV2 b1
             request and the phase's wall time.
11. codispatch  configs/benchmark_slo_mix_stream.json's worker (one GPU
             worker, fixed_worker, max_batch 32, dispatch_depth 8,
             co_dispatch 4) with MobileNetV2 at full width, effnetlite_int8,
             resnetish_int8 and fc_int8 in place of its models.
             warm_co_dispatch at b32 must capture the mix as one CUDA graph
             (else the run fails: no unfused fallback); printed: the graph
             pool's bytes (memory_reserved before and after the capture)
             and the kernel calls one replay makes.  Then 6 stream rounds
             of 32 requests per model, queued as one backlog (several
             fused dispatches in flight): every output byte-equal to the
             TFLite goldens, at least one fused dispatch per round, B1, B2,
             B3 and lut_softmax counted once per captured call and replay,
             and each model's per-share estimate below the fused window's
             time.  A b16 mix captured while b32 rounds are being served
             (capture_error_mode thread_local), its rounds fused and
             byte-equal.  Printed: host time per invoke_multi against the
             four solo windows' launches, one replay's device time,
             torch.profiler's busy share of two served rounds, and rounds/s
             with co_dispatch 4 against 1 (three runs each, alternating,
             with the spread).
12. monitor  the resource monitor at a 200 ms interval on two GPU workers
             (cuda:0) and a host worker under shortest_expected_latency:
             its snapshot must hold gpu0_duty_cycle_pct, gpu0_clock_hz
             (nvidia-smi) and dev0_hbm_in_use_bytes / dev0_hbm_limit_bytes
             (PyTorch); an hbm_limit_fraction below the in-use fraction
             throttles both GPU workers, so MobileNetV2 runs on the host
             worker until the limit is lifted, byte-equal throughout.
13. benchmark  band_tpu_torch.tools.benchmark in-process for 3 s on the
             layouts of configs/benchmark_rr_cnn.json (round_robin, two
             GPU workers, stream), configs/benchmark_slo_mix.json (LSF,
             GPU + host, periodic; MobileNetV2 slo_scale 2, fc_int8 slo_us
             50000) and the codispatch phase's, written as JSON with
             absolute tests/data paths; one ``benchmark:`` line each.
             Every model processes requests, none is canceled without an
             SLO, and the codispatch config's rounds fuse.
Then it prints the kernels line (each kernel's launches in the engine
phase of its numerics, in the sr phase and in the codispatch phase; B2's
general branch, the mma kernel of csrc/qconv_mma.cuh, in two entries of
its own, exact and fast, with its launches and a b1 FSRCNN request's
times from the sr phase), and last the device line.
"""

import collections
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
HETERO_GOLDENS = os.path.join(DATA, "torch_hetero_goldens.npz")
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
SSD_MODELS = ("ssd_int8", "ssd_regular_int8")
HETERO_SCHEDULERS = (
    "fixed_worker_global_queue", "round_robin", "shortest_expected_latency",
    "heterogeneous_earliest_finish_time",
    "heterogeneous_earliest_finish_time_reserved", "least_slack_time_first")
# schedulers that price paths through the DP and split models around
# the custom op (the others run a model's largest subgraph on one worker)
SPLITTING = HETERO_SCHEDULERS[2:]
HETERO_SYNC = 2
HETERO_ASYNC = 4
# an SSD burst no wider than the GPU workers: a wider one may leave a
# request whose fastest path is the whole model on the host (both GPU
# workers booked), which SEL rightly takes (seen on the card), and the
# GPU -> host hop is checked on every SSD request
SSD_ASYNC = 2
SSD_IMAGE = (1, 32, 32, 3)
# the SSD backbones' batches in the hetero phase: b1 (sync requests), the
# async burst's bucket, and the bucket warm-up's largest
SSD_BATCHES = (1, SSD_ASYNC, MAX_BATCH)
SSD_BOX_ATOL = 1e-6  # TFLite's box decode against band_tpu's numpy one
# codispatch: configs/benchmark_slo_mix_stream.json's worker, its models
# replaced by MODELS (MobileNetV2 at full width)
CO_BATCH = 32
CO_DEPTH = 8
# backlogs (4 x 32 requests a round) stay within the planner's 1000
# finished-job records, which get_outputs reads
CO_ROUNDS = 6        # the checked backlog: fused dispatches in flight
CO_SHORT = 3         # requests a model fewer in a checked backlog's last round
CO_RATE_ROUNDS = 6   # the backlog of each timed run, fused or not
CO_HOST_REPS = 10
CO_PROFILED = 2
MONITOR_MS = 200
MONITOR_REQUESTS = 2  # MobileNetV2 requests under and after the HBM limit
BENCH_MS = 3000
FAST = ("qmatmul_fast", "qconv2d_fast", "qdwconv2d_fast")
EXACT_ONLY = ("qmatmul_exact", "qconv2d_exact", "qdwconv2d_exact")
# sr: FSRCNN(d=56, s=12, m=4) x2 at its published widths on the 360x640
# low-resolution frame of 720p (tests/gen_torch_fsrcnn_model.py)
OPS_GOLDENS = os.path.join(DATA, "torch_ops_goldens.npz")
SR_MODEL = "fsrcnn_x2_int8"
DECODER_MODELS = ("fsrcnn_x2_small_int8", "tconv_int8", "cnn_ops_int8",
                  "attention_int8")
SR_SYNC = 16
SR_BURST = 32
SR_KERNELS = {"exact": ("qmatmul_exact", "qconv2d_exact"),
              "fast": ("qmatmul_fast", "qconv2d_fast")}
# B2's general branch (csrc/qconv_mma.cuh), counted apart from its
# wrapper's other launches; its main path is the sr phase
MMA_KERNELS = {
    "qconv2d_exact_mma": dict(
        wrapper="qconv2d_exact",
        source="band_tpu_torch/ops/kernels/csrc/qconv_mma.cuh",
        replaces="band_tpu/ops/pallas/qconv.py:152"),
    "qconv2d_fast_mma": dict(
        wrapper="qconv2d_fast",
        source="band_tpu_torch/ops/kernels/csrc/qconv_mma.cuh",
        replaces="band_tpu/ops/lowerings.py:563"),
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


def sha256(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _inputs(z, name, g, n):
    td = g.tensor(g.inputs[0])
    xs = golden_inputs(int(z[f"{name}/seed"]), td.shape, td.dtype, n)
    check(sha256(xs) == str(z[f"{name}/input_sha"]),
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


def load_ops_goldens(graphs):
    """Goldens of the decoder models (tests/gen_torch_ops_goldens.py):
    xs; for the small models per output the exact golden, its tolerance
    in quant units and band_tpu's fast output; for the full-width FSRCNN
    the sha256 of each request's exact (TFLite) and fast (band_tpu)
    output."""
    z = np.load(OPS_GOLDENS)
    out = {}
    for name in DECODER_MODELS + (SR_MODEL,):
        n_out = len(graphs[name].outputs)
        d = {}
        if f"{name}/exact_sha" in z:
            for kind in ("exact_sha", "fast_sha"):
                d[kind] = [str(v) for v in z[f"{name}/{kind}"]]
            n = len(d["exact_sha"])
        else:
            d["exact"] = [z[f"{name}/exact{j}"] for j in range(n_out)]
            d["tol"] = [int(z[f"{name}/tol{j}"]) for j in range(n_out)]
            if f"{name}/fast0" in z:
                d["fast"] = [z[f"{name}/fast{j}"] for j in range(n_out)]
            n = len(d["exact"][0])
        d["xs"] = _inputs(z, name, graphs[name], n)
        out[name] = d
    return out


def decoder_outputs_ok(gd, outs, idx, exact):
    """Whether a decoder model's outputs for the golden requests ``idx``
    (stacked, numpy) are its goldens: the digests of each request's
    output (FSRCNN at full width), or each output within its tolerance
    (fast numerics: 0, against band_tpu's fast outputs)."""
    if "exact_sha" in gd:
        digests = gd["exact_sha" if exact else "fast_sha"]
        return all(sha256(outs[0][k:k + 1]) == digests[i]
                   for k, i in enumerate(idx))
    want = gd["exact" if exact else "fast"]
    for j, (o, w) in enumerate(zip(outs, want)):
        w = np.concatenate([w[i] for i in idx])
        if o.shape != w.shape or o.dtype != w.dtype:
            return False
        tol = gd["tol"][j] if exact else 0
        if o.dtype.kind == "f":
            if not np.array_equal(o, w):
                return False
        elif np.abs(o.astype(np.int64) - w.astype(np.int64)).max() > tol:
            return False
    return True


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


def b2_plan(args, kw, out):
    """The conv_plan a captured B2 call (exact or fast) ran under."""
    from band_tpu_torch.ops.kernels import qconv as QC

    x, w = args[0], args[1]
    return QC.conv_plan(x.shape[0], out.shape[1], out.shape[2], x.shape[3],
                        w.shape[1], kw["kh"], kw["kw"], tuple(kw["stride"]),
                        tuple(kw["dilation"]), QC.alignment(w))


def plan_of(name, args, kw, out):
    """The plan branch an exact kernel call ran under, as a label."""
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops.kernels import softmax as SM

    if name == "qmatmul_exact":
        p = K.gemm_plan(args[0].shape[0], args[1].shape[1], args[0].shape[1])
        return f"{p.bm}x{p.bn} splits {p.splits}"
    if name == "qdwconv2d_exact":
        return dwconv_plan_of(args, kw, out).name
    if name == "qconv2d_exact":
        return b2_plan(args, kw, out).name
    depth = args[0].shape[-1]
    return SM.softmax_plan(args[0].numel() // depth, depth).name


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


def held(torch, worst, name, args, kw, out, want, what):
    """same() of a captured kernel call: its error goes into worst[name],
    and into worst[name + "_mma"] where B2 took the mma branch."""
    err = same(torch, name, out, want, what)
    worst[name] = max(worst[name], err)
    if (name in ("qconv2d_exact", "qconv2d_fast")
            and b2_plan(args, kw, out).branch == "mma"):
        worst[name + "_mma"] = max(worst[name + "_mma"], err)


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
    the mma branch (Oc 70, 5x5 with Oc 9, Ci 56 and 72, Oc 1, 4, 12 and
    65); then on geometries that reach every compiled direct instance (1,
    2 and 4 words per pixel; 3x3 and other taps) each direct variant
    forced onto a ragged 2x4 tile, and on those and the mma shapes (K of
    147,456 bytes in channel groups among them) the mma branch forced with
    each N tile (8, 16, 32) on 128- and 256-pixel tiles and as a gathering
    block, and qgemm.cuh's loop forced, each with w_zp 0 and 3 and int8
    and uint8 outputs.  Per-channel and per-tensor multipliers in turn."""
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
        (1, 9, 9, 16, 70, 3, 3, (1, 1), same, 0),       # mma
        (2, 12, 12, 5, 9, 5, 5, (1, 2), ((2, 2), (1, 2)), 0),
        (1, 10, 11, 3, 16, 3, 5, (1, 1), ((1, 1), (2, 2)), 0),
        (1, 9, 8, 16, 16, 5, 3, (2, 1), ((2, 2), (1, 1)), 1),
    ]
    mma_geoms = [
        (1, 23, 37, 56, 4, 5, 5, (1, 1), ((2, 2), (2, 2)), 0),
        (2, 17, 21, 12, 12, 3, 3, (1, 1), same, 0),
        (1, 13, 19, 56, 1, 5, 4, (1, 1), ((2, 1), (2, 2)), 0),
        (1, 11, 9, 72, 65, 3, 3, (2, 2), s2, 1),
        (1, 9, 70, 200, 32, 3, 3, (1, 1), same, 0),   # 3 channel groups
        (1, 5, 7, 16384, 24, 3, 3, (1, 1), same, 0),  # K >= 2^17 bytes
    ]
    cases = []
    i = 0
    for geom in geoms + mma_geoms:
        cases += add(geom, i)
        i += 1

    def mma(v, pixels, gather=False):
        def plan(n, oh, ow, ci, oc, kh, kw, st):
            th, tw = QC.mma_tile(pixels)
            return QC.mma_plan(v, n, oh, ow, oc, kh, kw, st, (1, 1), th,
                               tw, QC.general_plan(n, oh, ow, ci, oc, kh, kw,
                                                   st, (1, 1)).slabs, gather)
        return plan

    forcings = [lambda n, oh, ow, ci, oc, kh, kw, st: QC.loop_plan(
        n, oh, ow, oc)]
    forcings += [mma(v, pixels) for v in range(len(QC.MMA_NTILES))
                 for pixels in QC.MMA_PIXELS]
    forcings += [mma(v, QC.MMA_PIXELS[0], gather=True)
                 for v in range(len(QC.MMA_NTILES))]
    direct = [lambda n, oh, ow, ci, oc, kh, kw, st, v=v: QC.direct_plan(
        v, n, oh, ow, ci, oc, kh, kw, st, (1, 1), 2, 4)
        for v in range(len(QC.DIRECT_VARIANTS))]
    # every instance: 1, 2 and 4 words per pixel, 3x3 and other taps; the
    # mma branch's N tiles and pixel tiles, with one and several groups
    direct_geoms = (geoms[1], geoms[4], geoms[5], geoms[7], geoms[10],
                    geoms[11])
    for geom in direct_geoms + tuple(mma_geoms):
        for plan in forcings + (direct if geom in direct_geoms else []):
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


def ssd_backbone(graphs, name):
    """The program of an SSD model's backbone (every op but the detection
    post-process): what a GPU worker runs of it in the hetero phase."""
    from band_tpu_torch.backend.program import build_program

    g = graphs[name]
    return build_program(g, [op.index for op in g.ops if not op.is_custom])


def same_bytes(got, want):
    """A tensor's bytes, dtype and shape equal to a numpy array's."""
    got = got.detach().cpu().numpy()
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def codispatch_bucket_calls(torch, dev, graphs, goldens, plain, worst,
                            names):
    """Every kernel call of the codispatch phase's models at the buckets
    its graphs capture (b32, b16), whose shapes pick other plan branches
    than b1/b8, held byte-equal to plain (``worst`` gathers the errors);
    and each model's output there byte-equal to the goldens."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import lowerings as L

    branches = collections.Counter()
    for name in names:
        g = graphs[name]
        prog = build_program(g, range(len(g.ops)), exact=True)
        params = params_from_jax(prog.params, dev)
        fn = prog.make_fn()
        gx = goldens[name]["xs"]
        for b in (CO_BATCH, CO_BATCH // 2):
            idx = _round_inputs(0, b, len(gx))
            x = torch.from_numpy(np.concatenate([gx[i] for i in idx])).to(
                dev)
            calls = capture_calls(L, fn, params, [x])
            torch.cuda.synchronize()
            for kname, args, kw, out in calls:
                want = plain[kname](*args, **kw)
                torch.cuda.synchronize()
                held(torch, worst, kname, args, kw, out, want,
                    f"{name} b{b} {tuple(args[0].shape)}")
                branches[(kname, plan_of(kname, args, kw, out))] += 1
            check(not any(n in FAST for n, *_ in calls),
                  f"{name} b{b}: a kernel of the fast numerics")
            (got,) = fn(params, [x])
            want = goldens[name]["output"][0]
            check(same_bytes(got, np.concatenate([want[i] for i in idx])),
                  f"{name} b{b}: the output on the card differs from the "
                  "goldens")
            log(f"kernels: {name} b{b}: {len(calls)} calls byte-equal to "
                f"plain (tolerance 0), its output byte-equal to the "
                "goldens")
    log(f"kernels: the codispatch buckets b{CO_BATCH}/b{CO_BATCH // 2} "
        f"held {sum(branches.values())} calls over {len(branches)} "
        "(kernel, plan branch) pairs: " + json.dumps(
            {f"{k} {p}": n for (k, p), n in sorted(branches.items())}))


def decoder_calls(torch, dev, graphs, ops_goldens, plain, worst):
    """Every kernel call of the decoder models (FSRCNN at full width and
    at 24x40, tconv_int8, cnn_ops_int8, attention_int8) at b1, b8 and in
    a b32 window, in exact numerics and, where there are fast goldens, in
    fast numerics, held byte-equal to plain; each model's outputs there
    equal to its goldens.  Returns FSRCNN's b1 calls by numerics (the sr
    phase times them)."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import lowerings as L

    sr_calls = {}
    for name in DECODER_MODELS + (SR_MODEL,):
        g, gd = graphs[name], ops_goldens[name]
        kinds = ["exact"] + (["fast"] if "fast" in gd or "fast_sha" in gd
                             else [])
        for kind in kinds:
            exact = kind == "exact"
            prog = build_program(g, range(len(g.ops)), exact=exact)
            params = params_from_jax(prog.params, dev)
            fn = prog.make_fn()
            pos = [prog.output_ids.index(t) for t in g.outputs]
            for b in (1, MAX_BATCH, CO_BATCH):
                idx = [i % len(gd["xs"]) for i in range(b)]
                x = torch.from_numpy(np.concatenate(
                    [gd["xs"][i] for i in idx])).to(dev)
                calls = capture_calls(L, fn, params, [x])
                torch.cuda.synchronize()
                for kname, args, kw, out in calls:
                    want = plain[kname](*args, **kw)
                    torch.cuda.synchronize()
                    held(torch, worst, kname, args, kw, out, want,
                        f"{name} {kind} b{b} {tuple(args[0].shape)}")
                check(not any(n in (FAST if exact else EXACT_ONLY)
                              for n, *_ in calls),
                      f"{name} {kind}: a kernel of the other numerics")
                outs = fn(params, [x])
                check(decoder_outputs_ok(
                    gd, [outs[p].cpu().numpy() for p in pos], idx, exact),
                    f"{name} {kind} b{b}: the output on the card differs "
                    "from the goldens")
                if name == SR_MODEL and b == 1:
                    sr_calls[kind] = calls
                used = collections.Counter(n for n, *_ in calls)
                log(f"kernels: {name} {kind} b{b}: {len(calls)} calls "
                    f"{dict(used)} byte-equal to plain (tolerance 0); the "
                    "output equal to the goldens")
                del calls, outs
                torch.cuda.empty_cache()
    return sr_calls


def kernel_phase(torch, dev, graphs, goldens, hetero_goldens, ops_goldens):
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
    worst = {n: 0 for n in list(KERNELS) + list(MMA_KERNELS)}

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
                    held(torch, worst, name, args, kw, out, want,
                        f"MobileNetV2 {what} b{b} {tuple(args[0].shape)}")
                check(not any(n in (EXACT_ONLY if not exact else FAST)
                              for n, *_ in calls),
                      f"MobileNetV2 {what}: a kernel of the other numerics")
                per_b[b] += calls
                log(f"kernels: MobileNetV2 {what} b{b}: {len(calls)} calls "
                    f"byte-equal to plain (tolerance 0)")

        # every call of the SSD backbones at the batches the hetero phase
        # runs them (the 3x3 convs with Ci 3 and 16, the 1x1 head convs
        # with N = 4), and the backbone's output byte-equal to TFLite's
        # detector input (every anchor, before NMS)
        for name in SSD_MODELS:
            prog = ssd_backbone(graphs, name)
            params = params_from_jax(prog.params, dev)
            fn = prog.make_fn()
            gd = hetero_goldens[name]
            for b in SSD_BATCHES:
                x = torch.from_numpy(np.concatenate(list(gd["xs"][:b]))).to(
                    dev)
                calls = capture_calls(L, fn, params, [x])
                torch.cuda.synchronize()
                for kname, args, kw, out in calls:
                    want = plain[kname](*args, **kw)
                    torch.cuda.synchronize()
                    held(torch, worst, kname, args, kw, out, want,
                        f"{name} b{b} {tuple(args[0].shape)}")
                kinds = sorted({n for n, *_ in calls})
                check({"qconv2d_exact", "qmatmul_exact"} <= set(kinds)
                      and not set(kinds) & set(FAST),
                      f"{name} b{b}: kernels {kinds}")
                (head,) = fn(params, [x])
                check(same_bytes(head, np.concatenate(list(gd["head"][:b]))),
                      f"{name} b{b}: the backbone's output on the card "
                      f"differs from TFLite's detector input")
                log(f"kernels: {name} backbone b{b}: {len(calls)} calls "
                    f"({', '.join(kinds)}) byte-equal to plain (tolerance "
                    f"0); its output byte-equal to TFLite's head")

        codispatch_bucket_calls(torch, dev, graphs, goldens, plain, worst,
                                MODELS)
        sr_calls = decoder_calls(torch, dev, graphs, ops_goldens, plain,
                                 worst)

        # (lut_softmax's b1 call is the same in both numerics: timed once)
        stats = {n: dict(launches_b1=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         bytes_s=0.0, ops_s=0.0, library_ms=None)
                 for n in KERNELS}
        # B2's mma branch: its b1 launches only (the sr phase times it)
        stats.update({n: dict(launches_b1=0) for n in MMA_KERNELS})
        softmax_calls = [c for c in per_b[1] if c[0] == "lut_softmax"]
        per_b[1] = [c for c in per_b[1] if c[0] != "lut_softmax"] + \
            softmax_calls[:1]
        wrapper = {n: getattr(K, n) for n in KERNELS}
        gemms = {}  # (M, N, K) -> calls and times of one call
        dwconvs = {}  # (input shape, stride) -> plan, calls, times
        for name, args, kw, out in per_b[1]:
            s = stats[name]
            s["launches_b1"] += 1
            if (name in ("qconv2d_exact", "qconv2d_fast")
                    and b2_plan(args, kw, out).branch == "mma"):
                stats[name + "_mma"]["launches_b1"] += 1
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
    return worst, stats, sr_calls


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
    branches forced (for B2 qgemm.cuh's __dp4a loop, the first port's
    general branch; for the softmax the thread and the row kernel), the
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
                loop = QC.loop_plan(n, out.shape[1], out.shape[2], oc)
                exact = lambda: K.qconv2d_exact(*args, **kw)  # noqa: E731
                fast = lambda: K.qconv2d_fast(*fargs, **fkw)  # noqa: E731
                gen = forced(QC, "conv_plan", loop)
                log("qconv: " + json.dumps({
                    "shape": "x".join(map(str, shape)), "oc": oc,
                    "stride": list(stride), "batch": b,
                    "calls": d["calls"], "plan": plan.name,
                    "blocks": plan.blocks, "threads": plan.threads,
                    "exact_ms": graph_ms(torch, exact),
                    "fast_ms": graph_ms(torch, fast),
                    "loop_exact_ms": graph_ms(torch, gen(exact)),
                    "loop_fast_ms": graph_ms(torch, gen(fast)),
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


def profile_phase(torch, dev, graphs, goldens, exact, name=FULL_WIDTH):
    """Where a b1 request's time goes below the engine (MobileNetV2, or
    ``name``): the executor's wall time per request (launch and wait),
    and the device time of every kernel it launches (torch.profiler),
    whose ratio is the device's busy share."""
    from band_tpu_torch.backend.executor import ModelExecutor

    g = graphs[name]
    x = goldens[name]["xs"][0]
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
        "model": name, "batch": 1,
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
# sr phase
# --------------------------------------------------------------------------

def sr_general_lines(torch, dev, sr_calls, smi):
    """One ``qconv_general:`` line per distinct B2 call of a b1 FSRCNN
    request off the direct kernel (the 3x3 12 -> 12 convs and the
    deconv's union conv): its plan, which must be the mma branch, B2 and
    B2 fast times, the same calls with qgemm.cuh's loop forced (the first
    port's general branch), the plain version's (eager), the largest
    |kernel - plain| (0, checked again here), the bound and a cuDNN
    float32 conv of the same shape (conv_library).  Checked first: in each numerics a request makes
    6 B2 calls, of which one (Ci 56) is the deconv."""
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops.kernels import qconv as QC

    shapes = {}
    for kind, calls in sr_calls.items():
        convs = [c for c in calls if c[0] in ("qconv2d_exact",
                                              "qconv2d_fast")]
        deconvs = [c for c in convs if c[1][0].shape[3] == 56]
        check(len(convs) == 6 and len(deconvs) == 1,
              f"sr {kind}: {len(convs)} B2 calls a request, "
              f"{len(deconvs)} of them the deconv (want 6 and 1)")
        for name, args, kw, out in convs:
            x, w = args[0], args[1]
            plan = b2_plan(args, kw, out)
            if plan.branch == "direct":
                continue
            check(plan.branch == "mma", f"sr {kind}: a B2 call of FSRCNN "
                  f"{tuple(x.shape)} took {plan.name}")
            key = (tuple(x.shape), kw["kh"], kw["kw"], w.shape[1],
                   tuple(tuple(p) for p in kw["padding"]))
            d = shapes.setdefault(key, dict(calls=0, plan=plan))
            d["calls"] += name == "qconv2d_exact"
            d.setdefault(name, (args, kw, out))
    check(shapes, "sr: no B2 call of FSRCNN took the general branch")
    plain = {"qconv2d_exact": K.qconv2d_plain,
             "qconv2d_fast": K.qconv2d_fast_plain}
    # per b1 request, summed over its mma calls, for the kernels line
    stats = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_s=0.0,
                     ops_s=0.0, library_ms=0.0, max_abs_err=0)
             for n in MMA_KERNELS}
    for (shape, kh, kw_, oc, pad), d in sorted(shapes.items()):
        plan = d["plan"]
        line = {"shape": "x".join(map(str, shape)), "taps": f"{kh}x{kw_}",
                "oc": oc, "padding": [list(p) for p in pad],
                "calls_per_request": d["calls"], "plan": plan.name,
                "blocks": plan.blocks, "smem": plan.smem}
        for name in ("qconv2d_exact", "qconv2d_fast"):
            args, kw, out = d[name]
            run = getattr(K, name)
            err = same(torch, name, run(*args, **kw),
                       plain[name](*args, **kw), f"sr {shape} {kh}x{kw_}")
            tag = "exact" if name == "qconv2d_exact" else "fast"
            line[f"{tag}_ms"] = graph_ms(torch, lambda: run(*args, **kw))
            loop = forced(QC, "conv_plan", QC.loop_plan(
                shape[0], out.shape[1], out.shape[2], oc))
            line[f"{tag}_loop_ms"] = graph_ms(
                torch, loop(lambda: run(*args, **kw)))
            line[f"{tag}_plain_ms"] = eager_ms(
                torch, lambda: plain[name](*args, **kw))
            line[f"{tag}_max_abs_err"] = err
        args, kw, out = d["qconv2d_exact"]
        line["bound_ms"] = bound_ms("qconv2d_exact", args, kw, out)
        line["library_ms"] = graph_ms(torch, conv_library(
            torch, dev, args, kw, depthwise=False))
        line["card"] = smi
        log("qconv_general: " + json.dumps(line))
        nbytes, ops, rate = work("qconv2d_exact", args, kw, out)
        for name, meta in MMA_KERNELS.items():
            tag = "exact" if meta["wrapper"] == "qconv2d_exact" else "fast"
            st, k = stats[name], d["calls"]
            st["ms"] += k * line[f"{tag}_ms"]
            st["plain_ms"] += k * line[f"{tag}_plain_ms"]
            st["bound_ms"] += k * line["bound_ms"]
            st["bytes_s"] += k * 1e3 * nbytes / HBM_BYTES_PER_S
            st["ops_s"] += k * 1e3 * ops / rate
            st["library_ms"] += k * line["library_ms"]
            st["max_abs_err"] = max(st["max_abs_err"],
                                    line[f"{tag}_max_abs_err"])
    return stats


def sr_b32(torch, dev, graphs, gd, smi):
    """FSRCNN's b32 stacked window (12.9 MB of activations a request):
    exact and fast through execute_batched, then both captured by
    build_combo as one CUDA graph and replayed; every output's sha256
    equal to its golden's.  Printed: the peak of allocated memory over
    the eager windows, the graph's capture time and one replay's device
    time."""
    from band_tpu_torch.backend.executor import (ModelExecutor, build_combo,
                                                 run_combo)

    g, xs = graphs[SR_MODEL], gd["xs"]
    window = [[xs[i % len(xs)]] for i in range(CO_BATCH)]

    def held(outs, kind, what):
        digests = gd[f"{kind}_sha"]
        check(all(sha256(o[0].cpu().numpy()) == digests[i % len(xs)]
                  for i, o in enumerate(outs)),
              f"sr b{CO_BATCH} {what} {kind}: an output differs from the "
              "golden")

    exs = [ModelExecutor(-3, g, 0, dev, exact=True),
           ModelExecutor(-4, g, 0, dev, exact=False)]
    keys = [ex.prepare_subgraph(range(len(g.ops)), [0]) for ex in exs]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for ex, key, kind in zip(exs, keys, ("exact", "fast")):
        held(ex.execute_batched(key, window), kind, "window")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    combo = build_combo([(key, CO_BATCH) for key in keys], exs)
    capture_s = time.perf_counter() - t0
    check(combo.graph is not None, "sr: the b32 combo was not captured")
    outs = run_combo(combo, [window, window])
    torch.cuda.synchronize()
    for group, kind in zip(outs, ("exact", "fast")):
        held(group, kind, "combo")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    combo.graph.replay()
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end)
    log(f"sr: b{CO_BATCH} windows, exact and fast, equal to the golden "
        f"digests; peak allocated {peak} bytes over them; both captured "
        f"as one CUDA graph in {capture_s:.2f} s, its replay "
        f"{replay_ms:.3f} ms for {2 * CO_BATCH} requests "
        f"({replay_ms / (2 * CO_BATCH):.4f} ms a request), byte-equal "
        f"({smi})")


def sr_phase(torch, dev, bt, K, graphs, ops_goldens, sr_calls, smi):
    """FSRCNN x2 at 360x640 on one GPU worker (fixed_worker, max_batch
    8), registered twice, exact and register_model(numerics="fast"):
    SR_SYNC request_sync at b1, then a burst of SR_BURST request_async,
    in each numerics; every output's sha256 equal to its golden's.
    Launch counts are zeroed just before and read just after: B1 and B2
    (exact) and their fast instances must launch, no other kernel.  Then
    the device time, launches and busy share of a b1 request in each
    numerics (torch.profiler), the b32 window and its CUDA graph
    (sr_b32) and the general-branch lines."""
    K.reset_launches()
    eng = _engine(bt, bt.DeviceFlag.GPU, "exact")
    gd = ops_goldens[SR_MODEL]
    xs, n = gd["xs"], len(gd["xs"])
    rates = {}
    try:
        path = os.path.join(DATA, f"{SR_MODEL}.tflite")
        t0 = time.perf_counter()
        mids = {"exact": eng.register_model(bt.Model.from_path(path)),
                "fast": eng.register_model(bt.Model.from_path(path),
                                           numerics="fast")}
        check(eng.wait_buckets_ready(timeout=600), "sr: bucket warm-up "
              "timed out")
        log(f"sr: {SR_MODEL} registered exact and fast, buckets "
            f"2..{MAX_BATCH} warm in {time.perf_counter() - t0:.2f} s")
        for kind, mid in mids.items():
            digests = gd[f"{kind}_sha"]
            ex = eng.model_record(mid).executors[0]
            check(ex.exact == (kind == "exact"), f"sr: {kind} numerics")
            t0 = time.perf_counter()
            outs = [eng.request_sync(mid, [xs[i % n]])
                    for i in range(SR_SYNC)]
            b1 = SR_SYNC / (time.perf_counter() - t0)
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]])
                   for i in range(SR_BURST)]
            burst_outs = [eng.wait(j) for j in ids]
            burst = SR_BURST / (time.perf_counter() - t0)
            served = list(enumerate(outs)) + [
                (i % n, o) for i, o in enumerate(burst_outs)]
            for i, (gi, o) in enumerate(served):
                check(len(o) == 1 and o[0].shape == (1, 720, 1280, 1)
                      and sha256(o[0]) == digests[gi % n],
                      f"sr: {kind} request {i}: the output differs from "
                      "the golden")
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"sr {kind}: the burst ran no batch "
                  "window")
            rates[kind] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            log(f"sr: {kind}: {SR_SYNC} sync and {SR_BURST} burst outputs "
                f"(720x1280) equal to the golden digests; b1 {b1:.2f} "
                f"req/s, burst {burst:.2f} req/s, windows "
                f"{dict(sorted(windows.items()))} ({smi})")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    ran = SR_KERNELS["exact"] + SR_KERNELS["fast"]
    for name in KERNELS:
        check((counts[name] > 0) == (name in ran),
              f"sr: kernel {name} launched {counts[name]} times")
    for name in MMA_KERNELS:
        check(counts[name] > 0, f"sr: {name} (B2's general branch) never "
              "launched")
    log(f"sr: launches {json.dumps(counts)}")
    sr_b32(torch, dev, graphs, gd, smi)
    for kind in ("exact", "fast"):
        p = profile_phase(torch, dev, graphs, ops_goldens, kind == "exact",
                          name=SR_MODEL)
        log(f"sr: {kind} per request: device {p['device_kernel_ms']} ms, "
            f"{p['launches']} launches, busy share "
            f"{p['device_busy_share']} ({smi})")
    mma_stats = sr_general_lines(torch, dev, sr_calls, smi)
    return counts, rates, mma_stats


# --------------------------------------------------------------------------
# hetero phase
# --------------------------------------------------------------------------

def load_hetero_goldens():
    """SSD goldens (tests/gen_torch_hetero_goldens.py): the regenerated
    images, per output the golden a served request must equal byte for
    byte (band_tpu's detection post-process on TFLite's head), and the
    head itself: the detection post-process's first input as TFLite
    computes it, which the backbone on the card must equal byte for
    byte."""
    import hashlib

    z = np.load(HETERO_GOLDENS)
    out = {}
    for name in SSD_MODELS:
        want = [z[f"{name}/output{k}"] for k in range(4)]
        tfl = [z[f"{name}/tflite{k}"] for k in range(4)]
        rng = np.random.default_rng(int(z[f"{name}/seed"]))
        xs = rng.standard_normal((len(want[0]), *SSD_IMAGE)).astype(
            np.float32)
        sha = hashlib.sha256(np.ascontiguousarray(xs).tobytes()).hexdigest()
        check(sha == str(z[f"{name}/input_sha"]),
              f"{name}: regenerated inputs differ from the goldens'")
        check(np.abs(want[0] - tfl[0]).max() <= SSD_BOX_ATOL
              and all(np.array_equal(a, b) for a, b in zip(want[1:], tfl[1:])),
              f"{name}: goldens outside their tolerance of TFLite")
        out[name] = dict(xs=xs, output=want, head=z[f"{name}/head"])
    return out


def _hetero_engine(bt, sched):
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType(sched))
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=MAX_BATCH))
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=MAX_BATCH))
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.CPU,
                                     device_ids=(0,), max_batch=1))
           .minimum_subgraph_size(1)
           .subgraph_preparation_type(
               bt.SubgraphPreparationType.MERGE_UNIT_SUBGRAPH)
           .profile_warmups(1).profile_runs(2)
           .build())
    cfg.probe_link_costs = True
    return bt.Engine.create(cfg)


def _check_dp(eng, tally):
    """Price every DP call of the engine twice, in the native plan core
    and in the Python DP, and count every disagreement.  Both run under
    the latency estimator's lock, which its every write takes, so the
    expected latencies both read are the same."""
    native = eng.get_subgraph_with_shortest_latency
    held = eng.latency_estimator._lock

    def checked(job, waiting):
        with held:
            got = native(job, waiting)
            ref = eng._py_get_subgraph_with_shortest_latency(job, waiting)
        tally["calls"] += 1
        if got != ref:
            tally["mismatches"] += 1
            tally.setdefault("first", f"{got} != {ref}")
        return got

    eng.get_subgraph_with_shortest_latency = checked


def _host_b1_ms(eng, mid, host, gd):
    """The host worker's time for one MobileNetV2 b1 request: its
    program run directly, twice, byte-checked; and the engine's profile
    of it."""
    key = eng.get_largest_subgraph_key(mid, host)
    ex = eng.model_record(mid).executors[host]
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        out = ex.execute(key, [gd["xs"][i]])
        runs.append(1e3 * (time.perf_counter() - t0))
        check(np.array_equal(out[0].numpy(), gd["output"][0][i]),
              "hetero: host worker's MobileNetV2 output differs")
    return dict(runs_ms=runs,
                profiled_ms=eng.latency_estimator.get_profiled(key) / 1e3)


def hetero_phase(torch, bt, K, goldens, hetero_goldens, smi):
    """GPU workers plus a host worker under every scheduler but
    fixed_worker; returns the phase's summary."""
    K.reset_launches()
    t_phase = time.perf_counter()
    gpus, host = (0, 1), 2
    tally = dict(calls=0, mismatches=0)
    heads_checked = 0
    summary = dict(card=smi, schedulers={})
    for sched in HETERO_SCHEDULERS:
        t0 = time.perf_counter()
        eng = _hetero_engine(bt, sched)
        try:
            check(eng.plan_core == "native",
                  f"hetero: the native plan core did not build: "
                  f"{eng.plan_core_error}")
            _check_dp(eng, tally)
            summary["link_costs"] = eng.link_costs.to_dict()
            mids = {name: eng.register_model(bt.Model.from_path(
                        os.path.join(DATA, f"{name}.tflite")))
                    for name in (FULL_WIDTH,) + SSD_MODELS}
            check(eng.wait_buckets_ready(timeout=600),
                  "hetero: bucket warm-up timed out")
            setup_s = time.perf_counter() - t0
            head_tid = {}
            for name in SSD_MODELS:
                rec = eng.model_record(mids[name])
                post = {op.index for op in rec.model.graph.ops
                        if op.is_custom}
                head_tid[name] = next(op.inputs[0] for op in
                                      rec.model.graph.ops if op.is_custom)
                custom = {u for u, ops in enumerate(rec.spec.unit_subgraph_ops)
                          if post & set(ops)}
                check(post and custom, f"hetero: {name} has no custom unit")
                for key in rec.subgraph_keys:
                    check(not (key.unit_indices & custom)
                          or key.worker_id == host,
                          f"hetero {sched}: {name}'s custom op prepared "
                          f"on worker {key.worker_id}")
            if "host_b1" not in summary:
                summary["host_b1"] = _host_b1_ms(
                    eng, mids[FULL_WIDTH], host, goldens[FULL_WIDTH])
            def windows():
                """Launch sequences run so far, by worker."""
                return {w: sum(
                    sum(eng.model_record(m).executors[w].windows.values())
                    for m in mids.values()
                    if w in eng.model_record(m).executors) for w in range(3)}

            before = windows()
            t0 = time.perf_counter()
            served = []  # (model, request index, job id)
            for name, mid in mids.items():
                gd = (goldens if name == FULL_WIDTH else hetero_goldens)[name]
                xs, want = gd["xs"], gd["output"]
                what = f"hetero {sched}: {name}"
                # one at a time: request_sync is request_async + wait;
                # the job id is kept to read the job's record
                for i in range(HETERO_SYNC):
                    jid = eng.request_async(mid, [xs[i]])
                    _same_outputs(eng.wait(jid, timeout=120), want, i,
                                  f"{what} sync")
                    served.append((name, i, jid))
                n_async = HETERO_ASYNC if name == FULL_WIDTH else SSD_ASYNC
                burst = [(i % len(xs), eng.request_async(mid, [xs[i % len(xs)]]))
                         for i in range(HETERO_SYNC, HETERO_SYNC + n_async)]
                for i, jid in burst:
                    _same_outputs(eng.wait(jid, timeout=120), want, i,
                                  f"{what} async")
                    served.append((name, i, jid))
            serve_s = time.perf_counter() - t0
            after = windows()
            last_hop = {}
            for name, i, jid in served:
                job = eng.planner.get_finished_job(jid)
                check(job is not None
                      and job.status == bt.JobStatus.SUCCESS,
                      f"hetero {sched}: {name} job {jid} has no record")
                w = job.subgraph_key.worker_id
                last_hop.setdefault(name, []).append(w)
                what = f"hetero {sched}: {name} job {jid}"
                if name in SSD_MODELS and sched in SPLITTING:
                    from_card = any(
                        isinstance(v, torch.Tensor) and v.is_cuda
                        for v in job.activations.values())
                    check(w == host and job.resolved_unit_subgraphs
                          and from_card, f"{what} took no GPU -> host hop")
                    # the continuation's input: the backbone's output as
                    # the GPU worker made it, byte for byte TFLite's
                    got = job.activations[head_tid[name]]
                    check(got.is_cuda and same_bytes(
                              got, hetero_goldens[name]["head"][i]),
                          f"{what}: the GPU worker's backbone output "
                          f"differs from TFLite's detector input")
                    heads_checked += 1
                elif name in SSD_MODELS:
                    check(w == host and not job.resolved_unit_subgraphs,
                          f"{what} did not run whole on the host worker")
                elif sched in SPLITTING[:3]:  # SEL, HEFT, HEFT-reserved
                    check(w in gpus, f"{what} left the GPU workers")
            dropped = None
            if sched == "least_slack_time_first":
                gd = goldens[FULL_WIDTH]
                jid = eng.request_async(mids[FULL_WIDTH], [gd["xs"][0]],
                                        bt.RequestOption(slo_us=100))
                st = eng.wait_all([jid], timeout=60)
                dropped = st.get(jid)
                check(dropped == bt.JobStatus.SLO_VIOLATION,
                      f"hetero {sched}: an unmeetable SLO ended {dropped}")
                dropped = dropped.name
            by_model = eng.get_model_execution_counts()
            ssd = eng.model_record(mids[SSD_MODELS[0]])
            rec = dict(
                ssd_int8_expected_us={
                    f"w{k.worker_id}:{sorted(k.unit_indices)}":
                        eng.get_expected_latency(k)
                    for k in ssd.subgraph_keys},
                setup_s=setup_s, serve_s=serve_s,
                executions_per_worker={w: after[w] - before[w]
                                       for w in range(3)},
                executions_per_model={name: by_model.get(mid, 0)
                                      for name, mid in mids.items()},
                last_hop_worker=last_hop,
                unmeetable_slo=dropped,
                engine_s=time.perf_counter() - t0 + setup_s)
            summary["schedulers"][sched] = rec
            log(f"hetero {sched}: {len(served)} requests of "
                f"{len(mids)} models byte-equal to their goldens; "
                + json.dumps(rec))
        finally:
            eng.shutdown()
    counts = K.launch_counts()
    for name in EXACT_ONLY + ("lut_softmax",):
        check(counts[name] > 0, f"hetero: kernel {name} never launched")
    check(tally["calls"] > 0, "hetero: no DP call was priced")
    check(heads_checked > 0, "hetero: no SSD backbone output was checked")
    check(tally["mismatches"] == 0,
          f"hetero: native and Python DP disagree on {tally['mismatches']} "
          f"of {tally['calls']} calls (first: {tally.get('first')})")
    summary.update(dp_calls=tally["calls"], dp_mismatches=tally["mismatches"],
                   ssd_heads_checked=heads_checked,
                   launches=counts, wall_s=time.perf_counter() - t_phase)
    log(f"hetero: DP parity: {tally['calls']} calls priced by the native "
        f"core and the Python DP, {tally['mismatches']} mismatches")
    log(f"hetero: {heads_checked} SSD continuations fed the GPU worker's "
        f"backbone output byte-equal to TFLite's detector input")
    log(f"hetero: link costs [fixed_us, bytes_per_us] "
        f"{json.dumps(summary['link_costs'])} ({smi}; ici and dcn are "
        f"not measured with one card and one process)")
    log("hetero: " + json.dumps(summary))
    return summary


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# codispatch, monitor and benchmark phases
# --------------------------------------------------------------------------

def _co_engine(bt):
    """configs/benchmark_slo_mix_stream.json's worker on the card."""
    return bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU, device_ids=(0,),
                                  max_batch=CO_BATCH, dispatch_depth=CO_DEPTH,
                                  co_dispatch=len(MODELS)))
        .build())


def _round_inputs(r, n, n_goldens):
    """The golden request of each of a round's ``n`` slots: shifted by one
    from round to round, so that every slot of a replay gets other bytes
    than the replay before it (a replay that overwrote uncloned outputs,
    or a static input left unfilled, then shows in the golden check)."""
    return [(r + i) % n_goldens for i in range(n)]


def _co_rounds(bt, eng, mids, staged, rounds, batch, short=0):
    """Stream rounds as a backlog: ``rounds`` rounds of ``batch`` requests
    of every model (in model order; inputs the goldens' by
    ``_round_inputs``, staged on the card as the benchmark tool stages
    them, so that no backlog outruns a model's input ring) queued while
    the worker is paused, then released.  The last round sends ``batch -
    short`` requests a model, a window the graph pads to its bucket.
    Returns the seconds from the release to the last completion and
    [(model, golden request, job id)]; every job must succeed."""
    w = eng.workers[0]
    w.pause()
    jobs = []
    try:
        for r in range(rounds):
            n = batch - short if r == rounds - 1 else batch
            for name, mid in mids.items():
                xs = staged[name]
                idx = _round_inputs(r, n, len(xs))
                ids = eng.request_async_batch([mid] * n,
                                              [[xs[i]] for i in idx])
                jobs += [(name, i, j) for i, j in zip(idx, ids)]
        deadline = time.monotonic() + 60
        while len(w._queue) < len(jobs) and time.monotonic() < deadline:
            time.sleep(0.002)
        check(len(w._queue) == len(jobs),
              "codispatch: the planner did not queue the backlog")
    finally:
        t0 = time.perf_counter()
        w.resume()
    st = eng.wait_all([j for _, _, j in jobs], timeout=600)
    secs = time.perf_counter() - t0
    bad = collections.Counter(v.name for v in st.values()
                              if v != bt.JobStatus.SUCCESS)
    check(len(st) == len(jobs) and not bad,
          f"codispatch: of {len(jobs)} requests {len(st)} ended, failed "
          f"{dict(bad)}")
    return secs, jobs


def _co_check(eng, goldens, jobs, what):
    for name, i, jid in jobs:
        _same_outputs(eng.get_outputs(jid), goldens[name]["output"], i,
                      f"{what}: {name}")


def _combo(eng, bucket):
    """The engine's captured combo whose members are all at ``bucket``."""
    sigs = [s for s, st in eng._combo_state.items()
            if st == "ready" and all(b == bucket for _, b in s)]
    check(len(sigs) == 1, f"codispatch: {len(sigs)} ready combos at "
          f"bucket {bucket}")
    combo = eng._combo_fns[sigs[0]]
    check(combo.graph is not None,
          "codispatch: the combo on the card is not a CUDA graph")
    return sigs[0], combo


def _median(v):
    return float(np.median(np.asarray(v, np.float64)))


def codispatch_phase(torch, bt, K, goldens, smi):
    """The four models' windows at b32 served as one CUDA graph per
    round; returns (launch counts of the served rounds, the summary)."""
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    eng = _co_engine(bt)
    summary = dict(card=smi, batch=CO_BATCH, models=list(MODELS))
    try:
        mids = {name: eng.register_model(bt.Model.from_path(
                    os.path.join(DATA, f"{name}.tflite")))
                for name in MODELS}
        check(eng.wait_buckets_ready(timeout=600),
              "codispatch: bucket warm-up timed out")
        for name, mid in mids.items():
            check(len(eng.model_record(mid).subgraph_keys) == 1,
                  f"codispatch: {name} is split into several subgraphs")
        staged = {name: [bt.StagedInput(x).stage(dev)
                         for x in goldens[name]["xs"]] for name in MODELS}
        # capture the mix with the engine idle: with the allocator's cache
        # emptied on both sides, what the card's reserved memory grew by is
        # the graph's private pool and the static buffers
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        check(eng.warm_co_dispatch(list(mids.values()), batch=CO_BATCH,
                                   timeout=600),
              f"codispatch: the b{CO_BATCH} mix was not captured "
              f"(state {list(eng._combo_state.values())}); no unfused "
              "fallback is accepted")
        capture_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_reserved(dev)
        pool_bytes = after - before
        sig, combo = _combo(eng, CO_BATCH)
        for name in EXACT_ONLY + ("lut_softmax",):
            check(combo.launch_tally.get(name, 0) > 0,
                  f"codispatch: kernel {name} is not in the captured graph")
        summary.update(
            capture_s=capture_s, graph_pool_bytes=pool_bytes,
            memory_reserved_before=before, memory_reserved_after=after,
            kernels_per_replay=combo.launch_tally)
        log(f"codispatch: {len(MODELS)} models at b{CO_BATCH} captured as "
            f"one CUDA graph in {capture_s:.2f} s (warm-up runs included); "
            f"graph pool {pool_bytes} bytes (memory_reserved "
            f"{before} -> {after}); kernel calls per replay "
            f"{json.dumps(combo.launch_tally)} ({smi})")

        # the main path: stream rounds, several fused dispatches in flight;
        # the fused records and the latency updates are watched
        w = eng.workers[0]
        recs, charged = [], []
        dispatch_multi, update = w._dispatch_multi, eng.update_latency

        def watch_dispatch(groups, gen=None):
            out = dispatch_multi(groups, gen)
            recs.append(out)
            return out

        def watch_update(key, latency_us, batch=1):
            charged.append((key, latency_us, batch))
            update(key, latency_us, batch)

        w._dispatch_multi, eng.update_latency = watch_dispatch, watch_update
        K.reset_launches()
        fused0 = eng.co_dispatch_count
        try:
            secs, jobs = _co_rounds(bt, eng, mids, staged, CO_ROUNDS,
                                    CO_BATCH, short=CO_SHORT)
        finally:
            del w._dispatch_multi, eng.update_latency
        counts = K.launch_counts()
        fused = eng.co_dispatch_count - fused0
        _co_check(eng, goldens, jobs, "codispatch")
        check(fused >= CO_ROUNDS,
              f"codispatch: {fused} fused dispatches for {CO_ROUNDS} rounds")
        for name, n in combo.launch_tally.items():
            check(counts[name] >= fused * n,
                  f"codispatch: {name} counted {counts[name]} launches, "
                  f"{fused} replays hold {fused * n}")
        check(any(len(r[0]) == CO_BATCH - CO_SHORT for d in recs for r in d),
              f"codispatch: no window of {CO_BATCH - CO_SHORT} requests was "
              "fused (the padded window)")
        log(f"codispatch: {CO_ROUNDS} rounds of {CO_BATCH} requests x "
            f"{len(MODELS)} models (the last {CO_BATCH - CO_SHORT}, padded "
            f"in the graph; each slot's golden shifted by one a round) in "
            f"{fused} fused dispatches, "
            f"{len(jobs)} outputs byte-equal to the TFLite goldens; "
            f"launches {json.dumps(counts)}")

        # each window of a fused dispatch is charged its share of the
        # dispatch's time, below the whole
        name_of = {mid: name for name, mid in mids.items()}
        share_of = {name: [] for name in mids}
        window_us = []
        for dispatch in recs:
            check(len(dispatch) == len(MODELS)
                  and abs(sum(r[3] for r in dispatch) - 1) < 1e-9,
                  "codispatch: a fused dispatch's shares do not add up to 1")
            full = dispatch[0][0][0].profiled_execution_time
            window_us.append(full)
            for jobs_, _, _, share in dispatch:
                key = jobs_[0].subgraph_key
                charge = max(int(jobs_[0].profiled_execution_time * share),
                             1)
                check((key, charge, len(jobs_)) in charged and charge < full,
                      f"codispatch: window {key} charged {charge} us of a "
                      f"{full} us fused dispatch")
                share_of[name_of[key.model_id]].append(share)
        estimates = {name: eng.get_expected_latency(
            eng.get_largest_subgraph_key(mid, 0), CO_BATCH)
            for name, mid in mids.items()}
        summary.update(fused_window_us=_median(window_us),
                       shares={k: _median(v) for k, v in share_of.items()},
                       estimates_us=estimates)
        log(f"codispatch: {len(recs)} fused dispatches, each window charged "
            f"its share (median {json.dumps(summary['shares'])}) of the "
            f"dispatch's time (median {summary['fused_window_us']:.0f} us, "
            f"dispatch to retire), below the whole; estimates at "
            f"b{CO_BATCH} now {json.dumps(estimates)} us")

        # a capture while the worker serves: b16 captured during b32 rounds
        import threading

        stop = threading.Event()
        served, errors = [], []

        def serve():
            try:
                r = 0
                while not stop.is_set():
                    t_a = time.perf_counter()
                    ids = []
                    for name, mid in mids.items():
                        xs = staged[name]
                        idx = _round_inputs(r, CO_BATCH, len(xs))
                        got = eng.request_async_batch(
                            [mid] * CO_BATCH, [[xs[i]] for i in idx])
                        ids += [(name, i, j) for i, j in zip(idx, got)]
                    st = eng.wait_all([j for _, _, j in ids], timeout=300)
                    check(all(v == bt.JobStatus.SUCCESS
                              for v in st.values()) and len(st) == len(ids),
                          "codispatch: a request failed during the capture")
                    served.append((t_a, time.perf_counter(), len(ids)))
                    _co_check(eng, goldens, ids, "codispatch concurrent")
                    r += 1
            except Exception as e:  # reported on the main thread
                errors.append(e)

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        while not served and not errors and th.is_alive():
            time.sleep(0.01)
        t_a = time.perf_counter()
        ok16 = eng.warm_co_dispatch(list(mids.values()), batch=CO_BATCH // 2,
                                    timeout=600)
        t_b = time.perf_counter()
        n_done = len(served)
        while len(served) < n_done + 1 and not errors and th.is_alive():
            time.sleep(0.01)
        stop.set()
        th.join(timeout=300)
        check(not th.is_alive(), "codispatch: the serving thread hung")
        if errors:
            raise errors[0]
        check(ok16, "codispatch: the b16 mix was not captured while the "
              "worker served")
        overlap = sum(1 for a, b, _ in served if a < t_b and b > t_a)
        check(overlap > 0, "codispatch: no round overlapped the capture")
        _combo(eng, CO_BATCH // 2)
        fused0 = eng.co_dispatch_count
        _, jobs16 = _co_rounds(bt, eng, mids, staged, CO_ROUNDS // 2,
                               CO_BATCH // 2, short=CO_SHORT)
        _co_check(eng, goldens, jobs16, "codispatch b16")
        check(eng.co_dispatch_count - fused0 >= CO_ROUNDS // 2,
              "codispatch: the b16 rounds did not fuse")
        summary.update(concurrent_capture_s=t_b - t_a,
                       rounds_during_capture=overlap)
        log(f"codispatch: the b{CO_BATCH // 2} mix captured in "
            f"{t_b - t_a:.2f} s while {overlap} b{CO_BATCH} rounds were "
            f"served ({sum(n for _, _, n in served)} outputs "
            f"byte-equal); then {CO_ROUNDS // 2} b{CO_BATCH // 2} rounds "
            f"(the last of {CO_BATCH // 2 - CO_SHORT} requests a model) "
            "fused, byte-equal")

        # host time per invoke_multi against the four solo windows'
        members = [(key, bucket, eng.model_record(key.model_id).executors[0])
                   for key, bucket in sig]
        multi_ms, solo_ms = [], []
        for rep in range(CO_HOST_REPS):
            gidx = [_round_inputs(rep, b, len(goldens[name_of[k.model_id]]
                                              ["xs"]))
                    for k, b, _ in members]
            groups = [[[goldens[name_of[k.model_id]]["xs"][i]] for i in idx]
                      for (k, _, _), idx in zip(members, gidx)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng.invoke_multi(sig, groups)
            multi_ms.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            # host arrays fill the static buffers through pinned memory
            for (key, _, _), group, idx in zip(members, outs, gidx):
                name = name_of[key.model_id]
                for i, o in zip(idx, group):
                    _same_outputs([t.cpu().numpy() for t in o],
                                  goldens[name]["output"], i,
                                  f"codispatch invoke_multi: {name}")
            solo = 0.0
            for (key, _, ex), grp in zip(members, groups):
                t0 = time.perf_counter()
                ex.execute_batched(key, grp)
                solo += 1e3 * (time.perf_counter() - t0)
                torch.cuda.synchronize()
            solo_ms.append(solo)
        summary.update(invoke_multi_host_ms=multi_ms,
                       solo_windows_host_ms=solo_ms)
        log(f"codispatch: host time per invoke_multi {_median(multi_ms):.3f} "
            f"ms against {_median(solo_ms):.3f} ms for the four solo "
            f"b{CO_BATCH} windows' launches (medians of {CO_HOST_REPS}; "
            f"inputs stacked from host arrays in both; every invoke_multi "
            f"output byte-equal to the goldens) ({smi})")

        # the graph's device time, and the busy share of a served round
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        combo.graph.replay()
        start.record()
        for _ in range(CO_HOST_REPS):
            combo.graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / CO_HOST_REPS
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            secs_p, jobs_p = _co_rounds(bt, eng, mids, staged, CO_PROFILED,
                                        CO_BATCH)
        device_ms = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        _co_check(eng, goldens, jobs_p, "codispatch profiled")
        wall_ms = 1e3 * secs_p
        summary.update(
            graph_replay_device_ms=replay_ms,
            profiled_rounds=CO_PROFILED, profiled_wall_ms=wall_ms,
            profiled_device_ms=device_ms if device_ms > 0 else "not measured",
            busy_share=(device_ms / wall_ms if device_ms > 0
                        else "not measured"))
        log(f"codispatch: one replay of the b{CO_BATCH} graph {replay_ms:.3f} "
            f"ms on the card (CUDA events); {CO_PROFILED} served rounds under "
            f"torch.profiler: wall {wall_ms:.2f} ms, device kernels "
            f"{summary['profiled_device_ms']} ms, busy share "
            f"{summary['busy_share']} ({smi})")

        # rounds/s, fused against unfused, on the same engine and traffic
        spec = eng.workers[0].spec
        rates = {len(MODELS): [], 1: []}
        order = [len(MODELS), 1, 1, len(MODELS), len(MODELS), 1]
        for co in order:
            spec.co_dispatch = co
            fused0 = eng.co_dispatch_count
            secs, jobs = _co_rounds(bt, eng, mids, staged, CO_RATE_ROUNDS,
                                    CO_BATCH)
            _co_check(eng, goldens, jobs, f"codispatch co_dispatch {co}")
            n = eng.co_dispatch_count - fused0
            check((n >= CO_RATE_ROUNDS) if co > 1 else n == 0,
                  f"codispatch: co_dispatch {co} made {n} fused dispatches")
            rates[co].append(CO_RATE_ROUNDS / secs)
        spec.co_dispatch = len(MODELS)
        spread = {co: (max(v) - min(v)) / _median(v) for co, v in rates.items()}
        summary.update(rounds_per_s={str(k): v for k, v in rates.items()},
                       rounds_per_s_spread={str(k): v
                                            for k, v in spread.items()},
                       rate_order=order)
        log(f"codispatch: rounds/s (backlogs of {CO_RATE_ROUNDS} rounds, "
            f"{len(MODELS)} x b{CO_BATCH} a round, order {order}): "
            f"co_dispatch {len(MODELS)} {rates[len(MODELS)]}, "
            f"co_dispatch 1 {rates[1]}; spread (max - min) / median "
            f"{spread[len(MODELS)]:.3f} and {spread[1]:.3f} ({smi})")
    finally:
        eng.shutdown()
    summary["wall_s"] = time.perf_counter() - t_phase
    log("codispatch: " + json.dumps(summary))
    return counts, summary


def monitor_phase(torch, bt, goldens, smi):
    """The resource monitor on the card: its snapshot holds the card's
    keys, and an HBM limit below the in-use fraction throttles both GPU
    workers (one card), so SEL sends MobileNetV2 to the host until the
    limit is lifted."""
    gpus, host = (0, 1), 2
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.SHORTEST_EXPECTED_LATENCY)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=MAX_BATCH))
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0,), max_batch=MAX_BATCH))
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.CPU,
                                     device_ids=(0,), max_batch=1))
           .enable_monitor(interval_ms=MONITOR_MS)
           .profile_warmups(1).profile_runs(2)
           .build())
    # a limit no fraction reaches: the policy runs from the first poll
    cfg.monitor.hbm_limit_fraction = 1.0
    t_phase = time.perf_counter()
    eng = bt.Engine.create(cfg)
    try:
        mid = eng.register_model(bt.Model.from_path(
            os.path.join(DATA, f"{FULL_WIDTH}.tflite")))
        check(eng.wait_buckets_ready(timeout=600),
              "monitor: bucket warm-up timed out")
        keys = ("gpu0_duty_cycle_pct", "gpu0_clock_hz",
                "dev0_hbm_in_use_bytes", "dev0_hbm_limit_bytes")
        deadline = time.monotonic() + 10 * MONITOR_MS / 1e3 + 5
        snap = {}
        while time.monotonic() < deadline:
            snap = eng.resource_monitor.status()
            if all(k in snap for k in keys):
                break
            time.sleep(MONITOR_MS / 1e3 / 4)
        check(all(k in snap for k in keys),
              f"monitor: the snapshot lacks {[k for k in keys if k not in snap]}"
              f" (has {sorted(snap)})")
        card = {k: v for k, v in snap.items()
                if k.startswith(("gpu", "dev"))}
        frac = snap["dev0_hbm_in_use_bytes"] / snap["dev0_hbm_limit_bytes"]
        check(0 < frac < 1, f"monitor: in-use fraction {frac}")
        log(f"monitor: snapshot card keys {json.dumps(card)}; in-use "
            f"fraction {frac:.3e} ({smi})")
        gd = goldens[FULL_WIDTH]

        def serve(i, where, what):
            jid = eng.request_async(mid, [gd["xs"][i]])
            _same_outputs(eng.wait(jid, timeout=120), gd["output"], i,
                          f"monitor {what}")
            w = eng.planner.get_finished_job(jid).subgraph_key.worker_id
            check(w in where, f"monitor {what}: MobileNetV2 ran on worker "
                  f"{w}, not {where}")
            return w

        def wait_for(avail, what):
            deadline = time.monotonic() + 20 * MONITOR_MS / 1e3 + 5
            while time.monotonic() < deadline:
                if all(eng.is_worker_available(w) == avail for w in gpus):
                    return
                time.sleep(MONITOR_MS / 1e3 / 4)
            raise AssertionError(f"monitor: the GPU workers were not "
                                 f"{what} within the deadline")

        before = serve(0, gpus, "before the limit")
        t0 = time.perf_counter()
        eng.config.monitor.hbm_limit_fraction = frac / 4
        wait_for(False, "throttled")
        throttle_s = time.perf_counter() - t0
        check(eng.is_worker_available(host), "monitor: the host throttled")
        during = [serve(i, (host,), "under the limit")
                  for i in range(1, 1 + MONITOR_REQUESTS)]
        t0 = time.perf_counter()
        eng.config.monitor.hbm_limit_fraction = 1.0
        wait_for(True, "released")
        release_s = time.perf_counter() - t0
        after = [serve(i, gpus, "after the limit")
                 for i in range(1 + MONITOR_REQUESTS,
                                1 + 2 * MONITOR_REQUESTS)]
    finally:
        eng.shutdown()
    out = dict(card=smi, interval_ms=MONITOR_MS, snapshot=card,
               in_use_fraction=frac, limit=frac / 4,
               throttled_after_s=throttle_s, released_after_s=release_s,
               worker_before=before, workers_under_limit=during,
               workers_after=after,
               wall_s=time.perf_counter() - t_phase)
    log("monitor: " + json.dumps(out))
    return out


def _bench_configs():
    """The benchmark phase's configs: configs/benchmark_rr_cnn.json,
    configs/benchmark_slo_mix.json and the codispatch phase's layout
    (configs/benchmark_slo_mix_stream.json's worker), each on tests/data
    models with absolute paths."""
    def m(name, **kw):
        return dict(graph=os.path.join(DATA, f"{name}.tflite"), **kw)

    common = dict(running_time_ms=BENCH_MS, profile_online=True,
                  profile_warmup_runs=1, profile_num_runs=2)
    return {
        "rr_cnn": dict(
            common,
            models=[m("effnetlite_int8", period_ms=10, batch_size=2),
                    m("resnetish_int8", period_ms=10, batch_size=2)],
            schedulers=["round_robin"], execution_mode="stream",
            workers=[{"device": "gpu", "device_ids": [0]},
                     {"device": "gpu", "device_ids": [0]}]),
        "slo_mix": dict(
            common,
            models=[m(FULL_WIDTH, period_ms=10, batch_size=1, slo_scale=2.0),
                    m("fc_int8", period_ms=5, batch_size=2, slo_us=50000)],
            schedulers=["least_slack_time_first"],
            minimum_subgraph_size=1,
            subgraph_preparation_type="merge_unit_subgraph",
            execution_mode="periodic",
            workers=[{"device": "gpu", "device_ids": [0],
                      "max_batch": MAX_BATCH},
                     {"device": "cpu", "device_ids": [0]}]),
        "codispatch": dict(
            common,
            models=[m(name, batch_size=CO_BATCH, worker_id=0, slo_us=-1)
                    for name in MODELS],
            schedulers=["fixed_worker"], execution_mode="stream",
            workers=[{"device": "gpu", "device_ids": [0],
                      "max_batch": CO_BATCH, "dispatch_depth": CO_DEPTH,
                      "co_dispatch": len(MODELS)}]),
    }


def benchmark_phase(smi):
    """band_tpu_torch.tools.benchmark in-process on three configs written
    as JSON files; every model served, no cancellation without an SLO,
    and the codispatch config's rounds fused."""
    import tempfile

    from band_tpu_torch.tools.benchmark import Benchmark, BenchmarkConfig

    reports = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "band_tpu_torch",
                                                      "_build")) as tmp:
        for name, d in _bench_configs().items():
            path = os.path.join(tmp, f"benchmark_{name}.json")
            with open(path, "w") as f:
                json.dump(d, f)
            t0 = time.perf_counter()
            bench = Benchmark(BenchmarkConfig.from_json(path))
            try:
                setup_s = time.perf_counter() - t0
                report = bench.run()
            finally:
                bench.shutdown()
            report["setup_s"] = setup_s
            log(f"benchmark: {name} " + json.dumps(report) + f" ({smi})")
            has_slo = any(mm.get("slo_us", -1) > 0
                          or mm.get("slo_scale", -1) > 0
                          for mm in d["models"])
            for i in range(len(d["models"])):
                r = report[f"model_{i}"]
                check(r["processed"] > 0,
                      f"benchmark {name}: {r['model']} processed nothing")
                check(has_slo or r["canceled"] == 0,
                      f"benchmark {name}: {r['model']} canceled "
                      f"{r['canceled']} without an SLO")
            if name == "codispatch":
                check(report["runtime_health"]["co_dispatched_windows"] > 0,
                      "benchmark codispatch: no round fused")
            reports[name] = report
    return reports


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
              for n in FAST_MODELS + SSD_MODELS + DECODER_MODELS
              + (SR_MODEL,)}
    goldens = load_goldens(graphs)
    fast_goldens = load_fast_goldens(graphs)
    hetero_goldens = load_hetero_goldens()

    ops_goldens = load_ops_goldens(graphs)
    worst, stats, sr_calls = kernel_phase(torch, dev, graphs, goldens,
                                          hetero_goldens, ops_goldens)
    conv_softmax_lines(torch, dev, graphs, goldens, fast_goldens,
                       sm_mhz / 1e3)
    counts, rates = engine_phase(torch, bt, K, MODELS, goldens, card,
                                 bt.DeviceFlag.GPU, "exact")
    fast_counts, fast_rates = engine_phase(torch, bt, K, FAST_MODELS,
                                           fast_goldens, card,
                                           bt.DeviceFlag.GPU, "fast")
    mixed_phase(bt, K, goldens, fast_goldens, bt.DeviceFlag.GPU)
    sr_counts, sr_rates, mma_stats = sr_phase(torch, dev, bt, K, graphs,
                                              ops_goldens, sr_calls, smi)
    depth_phase(torch, dev, graphs, goldens, fast_goldens)
    profile_phase(torch, dev, graphs, goldens, exact=True)
    profile_phase(torch, dev, graphs, goldens, exact=False)
    hetero_phase(torch, bt, K, goldens, hetero_goldens, smi)
    co_counts, _ = codispatch_phase(torch, bt, K, goldens, smi)
    monitor_phase(torch, bt, goldens, smi)
    benchmark_phase(smi)

    log("engine: " + json.dumps({"card": smi, "numerics": "exact",
                                 "models": rates}))
    log("fast: " + json.dumps({"card": smi, "numerics": "fast",
                               "models": fast_rates}))
    log("sr: " + json.dumps({"card": smi, "model": SR_MODEL,
                             "numerics": sr_rates}))
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
            # replays of the fused b32 graph count its captured calls
            "codispatch_launches": co_counts[name],
            # the sr phase's FSRCNN x2 requests, exact and fast
            "sr_launches": sr_counts[name],
        })
    for name, meta in MMA_KERNELS.items():
        s = mma_stats[name]
        # B2's general branch: its launches on its main path, the sr
        # phase; the times of a b1 FSRCNN request's mma calls; its largest
        # error over those and every captured call that took it
        line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": sr_counts[name],
            "max_abs_err": max(s["max_abs_err"], worst[name]), "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_s"] >= s["ops_s"] else "operations",
            "library_ms": s["library_ms"],
            "mobilenet_v2_b1_launches": stats[name]["launches_b1"],
            "codispatch_launches": co_counts[name],
            "sr_launches": sr_counts[name],
        })
    log(json.dumps({"kernels": line}))
    log(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
