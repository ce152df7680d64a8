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
             float32 row sum).  Then the exact ADD/SUB kernel (qaddsub)
             on MobileNetV2's ten ADDs at b1, b7 and b32: every call
             byte-equal to its plain version, ten launches a run, the
             outputs equal to the goldens; at b1 and b32 one ``qaddsub:``
             line of the ten calls summed and one of the largest (kernel
             in the CUDA-graph harness, the int64 chain it replaced in
             the same harness and eager, the byte bound).
 4. engine  Engine.create with one GPU worker (fixed_worker, max_batch
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
             cuDNN float32 conv of the same shape.  One exact b1 request
             under the engine's device trace (start_device_trace /
             stop_device_trace), its output checked: an ``xprof:`` line.
 8. depth    the logits below each model's SOFTMAX, from the program on
             the card at b1 and stacked b8, byte-equal to the golden
             logits; and the fast program's output below the first MEAN,
             byte-equal to band_tpu's fast output stored in the fast
             goldens.
 9. profile  a b1 MobileNetV2 request through the executor, exact and
             fast: its wall time, and the device time of its kernels
             (torch.profiler); for exact, one more request under its own
             trace summed by graph op (band_tpu_torch.tools.xprof_summary):
             an ``xprof:`` line with the top 10 graph ops (device and
             host ms) and op types.
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
14. float   (run after sr) MobileNetV2 1.0/224 with fp16 and with
             dynamic-range post-training quantization
             (tests/data/mobilenet_v2_{fp16,dynrange}.tflite) at full width
             on one GPU worker (fixed_worker, max_batch 8), registered
             through the public API: 4 untimed and 16 timed
             request_sync and a burst of 32 request_async per model, every output's top-1 equal to
             TFLite's and its largest deviation within max(2 x band_tpu's
             on that request, 1e-4 x max|golden|)
             (tests/data/torch_float_goldens.npz); one dynamic-range
             request in a window beside a request scaled by 1000 and
             beside an all-zero one, within 1e-5 of max|output| of the
             request alone.  Launch counts zeroed just before and read
             just after: qmatmul_hybrid must launch, no int8 kernel.
             Printed: req/s at b1 and in the burst, the worst deviation,
             and device time, launches and busy share of a b1 request of
             each model.  Before the engine phases, every qmatmul_hybrid
             call of a dynamic-range request at b1 and b8 is held
             byte-equal to qmatmul_hybrid_plain, and the b1 calls are
             timed beside plain, the bound and torch._int_mm (or a
             float32 torch.matmul where _int_mm refuses the shape): one
             ``hybrid:`` line per distinct shape.
15. detect  (run after float) CenterNet MobileNetV2 FPN 512x512 int8
             with its top-k decode in the graph
             (tests/data/centernet_mnv2_fpn_int8.tflite) at full width on
             one GPU worker (fixed_worker, max_batch 8), registered twice,
             exact and register_model(numerics="fast"): every golden
             request at b1, 16 timed request_sync and a burst of 32
             request_async in each numerics, boxes, scores and classes
             byte-equal to TFLite's (exact) and band_tpu's fast outputs
             (tests/data/torch_detect_goldens.npz); on an executor of the
             model the 8 golden requests as one b8 window and reversed,
             equal request by request (each request's GATHER_ND reads its
             own maps).  Launch counts zeroed just before and read just
             after: B1, B2 (direct and mma), B3, their fast instances
             and qaddsub must launch, not the softmax or the hybrid GEMM.  TOPK_V2 on
             the card: an all-tied 1,474,560-value row gives indices
             0..99 in order, tied windows and a three-valued row the CPU's
             indices.  Printed: req/s at b1 and in the burst; device
             time, launches and busy share of a b1 request; one
             ``detect_kernels:`` line per numerics (each kernel's b1 calls
             timed, beside plain and the bound); one ``detect_decode:``
             line per numerics (the decode's ops, max pool to boxes, each
             run alone under torch.profiler: device time and launches by
             op type, beside the smallest backbone kernel call).  In the
             kernel phase every kernel call of the model at b1 and b8,
             exact and fast, is held byte-equal to plain, and the outputs
             there to the goldens.
16. seq    (run after detect) the Keras example "Bidirectional LSTM on
             IMDB" at full width (max_features 20,000, maxlen 200,
             Embedding 128, two Bidirectional(LSTM(64)), Dense(1,
             sigmoid); random weights; outputs the sigmoid and the first
             BiLSTM's sequence [1, 200, 128]) in both conversions
             (tests/data/imdb_bilstm.tar.xz: the fused LSTM ops, and
             Keras 3's WHILE loops), and lstm_seq_int8 exact and fast, on
             one GPU worker (fixed_worker, max_batch 8): per IMDB model
             the 8 golden reviews at b1 and a burst of 16 request_async,
             every output under the float gate (the sigmoid's decision
             TFLite's; each output's largest deviation at most max(2 x
             band_tpu's, 1e-4 x max|golden|): tests/data/
             torch_seq_goldens.npz), the two conversions within that
             bound of each other, the 8 reviews as one b8 window in order
             and reversed within it of each review alone; lstm_seq_int8
             within 1 LSB of TFLite at b1 and in a burst.  Launch counts
             zeroed just before and read just after: B1, B4 and
             lut_softmax must launch, no other kernel.  A co_dispatch
             worker serving both IMDB models interleaved must refuse to
             capture the mix and count the windows it serves unfused.
             Printed: req/s at b1 and in the burst, and per b1 request
             device time, launches, host syncs, busy share and the
             recurrences' share of the device time.  In the kernel phase
             every kernel call of lstm_seq_int8 at b1 and b8, exact and
             fast, is held byte-equal to plain.
17. frontend (run after benchmark) the full-width MobileNetV2 fed from
             camera frames (tests/data/torch_frontend_goldens.npz: eight
             1920x1080 frames from band_tpu_torch/buffer/synthetic.py,
             four RGB and four NV12, each regenerated here and checked
             against its sha256; band_tpu's AutoConvert tensor of each;
             TFLite's output on that tensor).  Gates, tolerance 0 unless
             stated: (1) the port's data plane on this host, native
             kernels and numpy paths, each frame within 1 code of the
             golden tensor (bytes compared mod 256: the int8 cast wraps),
             the share of differing bytes printed; (2) the golden tensors
             through Engine.request_sync, a burst of 8 request_async, HTTP
             POST /request (sync, and async + POST /wait), the router over
             two EngineServers (each its own engine and GPU worker on card
             0) under round_robin and least_loaded (both backends served,
             by their /stats), and the C ABI (example/main.c's
             BandEngineRequestSync, a subprocess): outputs byte-equal to
             TFLite's; (3) the card-processed tensors through the same
             routes, and raw frames through example/buffer_main.c's
             BandImageProcessorProcess (tensors equal to this process's
             pipeline): outputs equal to the engine's on the same tensor;
             (4) HTTP hot swap: DELETE /models/<id>, POST /models again,
             served right, /models and /stats list what is registered;
             (5) every kernel call of a b1 frame request byte-equal to
             plain (B1, B2's direct branch for the stem, B3, the softmax).
             Launch counts zeroed just before the engine and read after
             the router (the C programs launch in their own processes):
             B1, B2, B3, lut_softmax and qaddsub must launch, no other
             kernel.
             Printed beside the card's name and power limit: b1 req/s
             over 32 timed requests through the engine, HTTP, the router
             (each policy) and the C ABI; host ms per 1080p frame of each
             format to int8 224x224; frame -> answer ms (engine and
             buffer_main.c); preprocess_bench's MB/s per operator (the
             host CPU's).
18. mesh    (run last) one engine over two processes on card 0: this
             script started twice with ``--mesh-child <rank>
             <coordinator>`` (subprocess, after the kernels were built
             here), each owning cuda:0 as its local device (global ids 0
             and 1).  Process 0's engine holds a tp=2 mesh worker, a dp=2
             mesh worker and a single GPU worker (fixed_worker, max_batch
             8); process 1 replays its launches (parallel/spmd.py).  The
             8 MobileNetV2 goldens sync (16 timed) and as one burst
             through each worker, every output byte-equal to TFLite's and
             to the single worker's.  Launch counts zeroed just before and
             read just after in both processes: B1, B2, B3 and lut_softmax
             must launch in each, no other kernel.  Then every kernel call
             of one golden request through a tp=2 mesh over both
             processes (half width: B1 N 8-640, B2's stem 16 channels, B3
             C 16-480) byte-equal to plain in each process, and the
             benchmark tool's distributed branch for 3 s with the tp=2
             worker.  Last, in this process, a tp=2 mesh over cuda:0,1:
             served byte-equal where two cards are visible, else refused
             with ConfigError.  Printed beside the card's name and power
             limit: b1 req/s and ms a request per worker, gathers and
             broadcasts a request and their host ms, launches per
             process.
19. srfloat (run after float) FSRCNN x2 at 360x640 in float32 and with
             dynamic-range quantization (tests/data/fsrcnn_x2_{float,
             dynrange}.tflite, tests/gen_torch_fsrcnn_float_models.py)
             on one GPU worker (fixed_worker, max_batch 8), through the
             public API: the 4 golden requests, 8 timed request_sync and
             a burst of 8 request_async per model, every 720x1280 output
             finite and, at the 16,384 stored positions, within max(2 x
             the reference deviation, 1e-4 x max|golden|) of TFLite
             (tests/data/torch_srfloat_goldens.npz; the reference
             band_tpu's for float32, the port's CPU path's for dynamic
             range: ROADMAP fault C9); one b1 request of each under the
             engine's device trace (``xprof:`` lines).  Launch counts
             zeroed just before and read just after: qconv2d_hybrid (the
             hybrid deconv's union conv on B2's mma branch, float32 out)
             must launch, no other kernel.  Printed: req/s at b1 and in
             the burst, the worst deviation, and device time, launches
             and busy share of a b1 request of each model.  Before the
             engine phases, the hybrid deconv's call of a dynamic-range
             request at b1 and b8 is held byte-equal to
             qconv2d_hybrid_plain, and the b1 call timed beside plain,
             the bound and a cuDNN float32 transposed conv: the
             ``hybrid_conv:`` line.
Then it prints the kernels line (each kernel's launches in the engine
phase of its numerics, in the sr, codispatch, detect, seq, frontend and
mesh phases (the mesh's summed over both processes); B2's
general branch, the mma kernel of csrc/qconv_mma.cuh, in two entries of
its own, exact and fast, with its launches and a b1 FSRCNN request's
times from the sr phase; qmatmul_hybrid with its launches in the float
phase and a b1 dynamic-range request's times; qconv2d_hybrid with its
launches in the srfloat phase and a b1 dynamic-range FSRCNN request's
times), and last the device line.
"""

import collections
import json
import os
import subprocess
import sys
import threading
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
# float: MobileNetV2 1.0/224 with fp16 and with dynamic-range post-training
# quantization (tests/gen_torch_float_models.py), at full width and depth
FLOAT_GOLDENS = os.path.join(DATA, "torch_float_goldens.npz")
FLOAT_MODELS = ("mobilenet_v2_fp16", "mobilenet_v2_dynrange")
DYNRANGE = "mobilenet_v2_dynrange"
FLOAT_WARM = 4   # checked, untimed: a b1 request's first cuDNN plans
FLOAT_SYNC = 16
FLOAT_BURST = 32
ISOLATION_REL = 1e-5
# the hybrid GEMM (qmatmul.cu's mma core, HybridEpilogue); its main path
# is the float phase
HYBRID_KERNELS = {
    "qmatmul_hybrid": dict(
        source="band_tpu_torch/ops/kernels/csrc/qmatmul.cu",
        replaces="band_tpu/ops/lowerings.py:971"),
}
# srfloat: FSRCNN x2 at 360x640 in float32 and with dynamic-range
# quantization (tests/gen_torch_fsrcnn_float_models.py)
SRFLOAT_GOLDENS = os.path.join(DATA, "torch_srfloat_goldens.npz")
SRFLOAT_MODELS = ("fsrcnn_x2_float", "fsrcnn_x2_dynrange")
SR_DYNRANGE = "fsrcnn_x2_dynrange"
SRFLOAT_TIMED = 8
SRFLOAT_BURST = 8
# the hybrid conv (qconv_mma.cuh with requant.cuh HybridConvEpilogue); its
# main path is the srfloat phase
HYBRID_CONV_KERNELS = {
    "qconv2d_hybrid": dict(
        source="band_tpu_torch/ops/kernels/csrc/qconv_mma.cuh",
        replaces="band_tpu/ops/lowerings.py:2185"),
}
XPROF_DIR = os.path.join(ROOT, "band_tpu_torch", "_build", "xprof")
XPROF_TOP = 10
# detect: CenterNet MobileNetV2 FPN 512x512, full-int8, its top-k decode
# in the graph (tests/gen_torch_centernet_model.py)
DETECT_GOLDENS = os.path.join(DATA, "torch_detect_goldens.npz")
DETECT_MODEL = "centernet_mnv2_fpn_int8"
DETECT_SYNC = 16
DETECT_BURST = 32
# seq: the Keras IMDB bidirectional LSTM at full width, fused and as WHILE
# loops (tests/gen_torch_seq_models.py), and lstm_seq_int8
SEQ_GOLDENS = os.path.join(DATA, "torch_seq_goldens.npz")
SEQ_ARCHIVE = os.path.join(DATA, "imdb_bilstm.tar.xz")
SEQ_MODELS = ("imdb_bilstm", "imdb_bilstm_while")
SEQ_INT8 = "lstm_seq_int8"
SEQ_BURST = 16
SEQ_RAN = ("qmatmul_exact", "qmatmul_fast", "lut_softmax")
# frontend: the full-width MobileNetV2 fed camera frames through the data
# plane, the engine, the HTTP server, the router and the C ABI
# (tests/gen_torch_frontend_goldens.py)
FRONTEND_GOLDENS = os.path.join(DATA, "torch_frontend_goldens.npz")
FRONTEND_PATH = os.path.join(DATA, f"{FULL_WIDTH}.tflite")
FRAME_W, FRAME_H = 1920, 1080
FRONTEND_TIMED = 32
FRONTEND_HOST_REPS = 10
FRONTEND_RAN = ("qmatmul_exact", "qconv2d_exact", "qdwconv2d_exact",
                "lut_softmax")
# the exact ADD/SUB kernel (csrc/qaddsub.cu): the lowerings call it
# outside capture_calls' kernels; its own phase holds and times it
ADDSUB = "qaddsub"
ADDSUB_BATCHES = (1, 7, 32)
ADDSUB_TIMED = (1, 32)
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


def float_inputs(seed, shape, n):
    """tests/gen_torch_float_models.py's request inputs: uniform in
    [-1, 1], float32."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, *shape)).astype(np.float32)


def load_float_goldens(graphs):
    """Goldens of FLOAT_MODELS (tests/gen_torch_float_models.py): xs,
    TFLite's outputs and band_tpu's largest deviation from them, per
    request."""
    z = np.load(FLOAT_GOLDENS)
    out = {}
    for name in FLOAT_MODELS:
        want = z[f"{name}/tflite"]
        td = graphs[name].tensor(graphs[name].inputs[0])
        out[name] = dict(xs=float_inputs(int(z[f"{name}/seed"]), td.shape,
                                         len(want)),
                         output=want, dev=z[f"{name}/dev"])
    return out


def float_gate(out, golden, band_dev):
    """(ok, deviation, limit) of one float output: top-1 equal to TFLite's
    and the largest absolute deviation at most max(2 x band_tpu's on that
    request, 1e-4 x max|golden|)."""
    d = float(np.abs(out.astype(np.float64) - golden).max())
    limit = max(2.0 * float(band_dev), 1e-4 * float(np.abs(golden).max()))
    ok = (out.shape == golden.shape
          and int(out.argmax()) == int(golden.argmax()) and d <= limit)
    return ok, d, limit


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

def annotation(e):
    """Whether a CUDA event of torch.profiler is an annotation, not a
    kernel: a program's graph-op span (backend/program.py, opNNN_NAME) or
    a lowering's range (the recurrences'), which the profiler also lays
    over their kernels on the device's timeline."""
    from band_tpu_torch.ops import lowerings as L
    from band_tpu_torch.tools.xprof_summary import GRAPH_OP

    name = getattr(e, "key", None) or e.name
    return (bool(getattr(e, "is_user_annotation", False))
            or bool(GRAPH_OP.match(name))
            or name in (L.LSTM_STEPS, L.WHILE_ITERATIONS))


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
    saved = {n: getattr(L, n) for n in list(KERNELS) + list(HYBRID_KERNELS)
             + list(HYBRID_CONV_KERNELS)}

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


def kernel_phase(torch, dev, graphs, goldens, hetero_goldens, ops_goldens,
                 detect_goldens, seq_goldens):
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
        detect_b1 = detect_calls(torch, dev, graphs, detect_goldens, plain,
                                 worst)
        seq_calls(torch, dev, graphs, seq_goldens, plain, worst)

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
    return worst, stats, sr_calls, detect_b1


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
    ran, idle = ((EXACT_ONLY + ("lut_softmax", ADDSUB), FAST)
                 if numerics == "exact"
                 else (FAST + ("lut_softmax",), EXACT_ONLY + (ADDSUB,)))
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


def xprof_line(what, path, smi):
    """One ``xprof:`` line: a device trace summed by graph op
    (band_tpu_torch.tools.xprof_summary), the top XPROF_TOP graph ops and
    op types with their device and host ms."""
    from band_tpu_torch.tools import xprof_summary as X

    s = X.summarize(path, XPROF_TOP)
    check(s["total_ms"] > 0, f"xprof {what}: no device time in {path}")
    line = {"what": what, "device_ms": s["total_ms"],
            "modules": s["modules"],
            "top_graph_ops": [[op, ms, host] for ms, op, host
                              in s["by_graph_op"]],
            "by_op_type": [[t, ms] for ms, t in s["by_source"]],
            "card": smi}
    log("xprof: " + json.dumps(line))
    return s


def profile_phase(torch, dev, graphs, goldens, exact, name=FULL_WIDTH,
                  xprof=None):
    """Where a b1 request's time goes below the engine (MobileNetV2, or
    ``name``): the executor's wall time per request (launch and wait),
    and the device time of every kernel it launches (torch.profiler),
    whose ratio is the device's busy share.  With ``xprof`` (the card's
    name and limit), one more request under its own trace, summed by
    graph op (xprof_line)."""
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
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not annotation(e):
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
    if xprof is not None:
        with torch.profiler.profile(activities=acts) as prof:
            ex.execute(key, [x])
            torch.cuda.synchronize()
        os.makedirs(XPROF_DIR, exist_ok=True)
        path = os.path.join(XPROF_DIR, f"{name}-{out['numerics']}.json")
        prof.export_chrome_trace(path)
        xprof_line(f"{name} {out['numerics']} b1 (executor)", path, xprof)
    return out


# --------------------------------------------------------------------------
# addsub phase
# --------------------------------------------------------------------------

def addsub_phase(torch, dev, graphs, goldens, smi):
    """The exact ADD/SUB kernel on MobileNetV2's ten residual ADDs: every
    qaddsub call of a full-width request at each of ADDSUB_BATCHES
    byte-equal to qaddsub_plain, one launch an ADD, the program's outputs
    equal to the goldens; at ADDSUB_TIMED each call's device time (a CUDA
    graph of 20 launches) beside its byte bound (3 bytes an element) and
    the int64 chain it replaced, in the same harness (``chain_ms``, the
    device time before) and eager (``plain_ms``).  Logs a ``qaddsub:``
    line a timed batch, summed over the ten ADDs, and one for the largest
    shape; returns the b1 numbers of the kernels line."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L

    g = graphs[FULL_WIDTH]
    gd = goldens[FULL_WIDTH]
    prog = build_program(g, range(len(g.ops)), exact=True)
    params = params_from_jax(prog.params, dev)
    fn = prog.make_fn()
    kernel = L.qaddsub
    stats = dict(max_abs_err=0)
    for b in ADDSUB_BATCHES:
        idx = [i % len(gd["xs"]) for i in range(b)]
        x = torch.from_numpy(np.concatenate([gd["xs"][i] for i in idx]))
        calls = []

        def record(*args, **kw):
            out = kernel(*args, **kw)
            calls.append((args, kw, out))
            return out

        K.reset_launches()
        L.qaddsub = record
        try:
            with torch.inference_mode():
                (out,) = fn(params, [x.to(dev)])
        finally:
            L.qaddsub = kernel
        torch.cuda.synchronize()
        n = K.launch_counts()[ADDSUB]
        check(len(calls) == 10 and n == 10,
              f"addsub: MobileNetV2 b{b}: {len(calls)} qaddsub calls, {n} "
              "launches (its ten ADDs)")
        check(same_bytes(out, np.concatenate(
            [gd["output"][0][i] for i in idx])),
            f"addsub: MobileNetV2 b{b} differs from the goldens")
        for args, kw, got in calls:
            stats["max_abs_err"] = max(stats["max_abs_err"], same(
                torch, ADDSUB, got, K.qaddsub_plain(*args, **kw),
                f"MobileNetV2 b{b} {tuple(got.shape)}"))
        if b not in ADDSUB_TIMED:
            continue
        rows = []
        for args, kw, got in calls:
            rows.append(dict(
                shape=list(got.shape),
                ms=graph_ms(torch, lambda a=args, k=kw: K.qaddsub(*a, **k)),
                chain_ms=graph_ms(
                    torch, lambda a=args, k=kw: K.qaddsub_plain(*a, **k)),
                plain_ms=eager_ms(
                    torch, lambda a=args, k=kw: K.qaddsub_plain(*a, **k)),
                bound_ms=1e3 * 3 * got.numel() / HBM_BYTES_PER_S))
        total = {k: sum(r[k] for r in rows)
                 for k in ("ms", "chain_ms", "plain_ms", "bound_ms")}
        big = max(rows, key=lambda r: np.prod(r["shape"]))
        log("qaddsub: " + json.dumps(dict(
            batch=b, calls=len(rows), launches=n, **total,
            of_bound=total["ms"] / total["bound_ms"], card=smi)))
        log("qaddsub: " + json.dumps(dict(
            big, of_bound=big["ms"] / big["bound_ms"], card=smi)))
        if b == 1:
            stats.update(total, launches_b1=n)
    log(f"addsub: MobileNetV2 b{', b'.join(map(str, ADDSUB_BATCHES))}: "
        "every qaddsub call byte-equal to plain (tolerance 0), ten "
        "launches a run, the outputs equal to the goldens")
    return stats


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


def engine_xprof(eng, mid, x, digest, what, smi):
    """One request through the engine under its device trace
    (start_device_trace / stop_device_trace: every thread's host ops and
    graph-op spans, the card's kernels), its output checked (its golden's
    sha256, or a check function), then xprof_line."""
    eng.start_device_trace(XPROF_DIR)
    try:
        out = eng.request_sync(mid, [x])
    finally:
        path = eng.stop_device_trace()
    check(digest(out[0]) if callable(digest) else sha256(out[0]) == digest,
          f"xprof {what}: the traced request's output is wrong")
    return xprof_line(what, path, smi)


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
            if kind == "exact":
                engine_xprof(eng, mid, xs[0], digests[0],
                             f"{SR_MODEL} exact b1 (engine)", smi)
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
    check(counts[ADDSUB] == 0, f"sr: FSRCNN has no ADD, yet {ADDSUB} "
          f"launched {counts[ADDSUB]} times")
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
# float phase: MobileNetV2 fp16 and dynamic range, and the hybrid GEMM
# --------------------------------------------------------------------------

def same_float(torch, name, got, want, what):
    """A float32 kernel output byte-equal to its plain version's; returns
    the largest |kernel - plain| (0)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} {what}: {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    err = (got - want).abs().max().item()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"{name} {what}: kernel and plain differ in their bytes (max "
          f"|diff| {err})")
    return err


def hybrid_work(args, kw, out):
    """(bytes, int8 ops) of one qmatmul_hybrid call: A and B read once,
    the epilogue's vectors (bias, w_scale, w_rowsum per column; zp and
    scale per quantized row), the float32 output written once."""
    a, b = args[0], args[1]
    vecs = [t for t in list(args[2:]) + [kw.get("bias")]
            if hasattr(t, "numel")]
    nbytes = a.numel() + b.numel() + sum(4 * t.numel() for t in vecs) \
        + 4 * out.numel()
    return nbytes, 2 * out.numel() * a.shape[1]


def hybrid_library(torch, args):
    """The hybrid GEMM's yardstick, (label, call): torch._int_mm on the
    int8 operands where cuBLASLt takes the shape (more than 16 rows, K
    and N multiples of 8; B column-major), else a float32 torch.matmul
    of them (TF32 off).  Neither has the epilogue; the port calls
    neither."""
    a, b = args[0], args[1]
    m, k = a.shape
    if m > 16 and k % 8 == 0 and b.shape[1] % 8 == 0:
        bt = b.t().contiguous().t()
        return "torch._int_mm", lambda: torch._int_mm(a, bt)
    check(not torch.backends.cuda.matmul.allow_tf32, "matmul with TF32")
    af, bf = a.float(), b.float()
    return "torch.matmul float32", lambda: torch.matmul(af, bf)


def hybrid_kernel_lines(torch, dev, graphs, float_goldens, smi):
    """Every qmatmul_hybrid call of a dynamic-range MobileNetV2 request at
    b1 and b8, captured from the model's program on the card and held
    byte-equal to qmatmul_hybrid_plain; the b1 calls timed (a CUDA graph
    of 20 launches), beside the plain version (eager), the bound and the
    yardstick (hybrid_library), one ``hybrid:`` line per distinct b1
    shape.  Returns the kernels line's numbers: sums over a b1 request's
    calls."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L

    g = graphs[DYNRANGE]
    xs = float_goldens[DYNRANGE]["xs"]
    prog = build_program(g, range(len(g.ops)), device=dev)
    params = params_from_jax(prog.params, dev)
    fn = prog.make_fn()
    worst, b1 = 0.0, []
    with torch.inference_mode():
        for b in (1, MAX_BATCH):
            x = torch.from_numpy(np.concatenate(list(xs[:b]))).to(dev)
            calls = capture_calls(L, fn, params, [x])
            torch.cuda.synchronize()
            kinds = {n for n, *_ in calls}
            check(kinds == {"qmatmul_hybrid"},
                  f"float: {DYNRANGE} b{b} ran kernels {sorted(kinds)}")
            for name, args, kw, out in calls:
                want = K.qmatmul_hybrid_plain(*args, **kw)
                torch.cuda.synchronize()
                worst = max(worst, same_float(
                    torch, name, out, want,
                    f"{DYNRANGE} b{b} {tuple(args[0].shape)}x"
                    f"{tuple(args[1].shape)}"))
            if b == 1:
                b1 = calls
            log(f"float: {DYNRANGE} b{b}: {len(calls)} qmatmul_hybrid calls "
                f"byte-equal to plain (tolerance 0)")
        s = dict(launches_b1=len(b1), ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 bytes_s=0.0, ops_s=0.0, library_ms=0.0, library={},
                 max_abs_err=worst)
        shapes = {}
        for name, args, kw, out in b1:
            ms = graph_ms(torch, lambda: K.qmatmul_hybrid(*args, **kw))
            pms = eager_ms(torch, lambda: K.qmatmul_hybrid_plain(*args, **kw))
            nbytes, ops = hybrid_work(args, kw, out)
            bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
            label, lib_fn = hybrid_library(torch, args)
            lib = graph_ms(torch, lib_fn)
            s["ms"] += ms
            s["plain_ms"] += pms
            s["bytes_s"] += bt
            s["ops_s"] += ot
            s["bound_ms"] += max(bt, ot)
            s["library_ms"] += lib
            s["library"][label] = s["library"].get(label, 0) + 1
            m, k = args[0].shape
            key = (m, args[1].shape[1], k, kw.get("rows", 1),
                   "asym" if args[4] is not None else "sym")
            d = shapes.setdefault(key, dict(calls=0, ms=[], plain_ms=[],
                                            library_ms=[], library=label,
                                            bound_ms=max(bt, ot)))
            d["calls"] += 1
            d["ms"].append(ms)
            d["plain_ms"].append(pms)
            d["library_ms"].append(lib)
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    for (m, n, k, rows, form), d in sorted(shapes.items(),
                                           key=lambda kv: -kv[0][0]):
        p = K.gemm_plan(m, n, k)
        log("hybrid: " + json.dumps({
            "M": m, "N": n, "K": k, "rows_per_quantized_row": rows,
            "inputs": form, "calls_b1": d["calls"],
            "tile": f"{p.bm}x{p.bn}", "splits": p.splits,
            "ms": mean(d["ms"]), "plain_ms": mean(d["plain_ms"]),
            "library": d["library"], "library_ms": mean(d["library_ms"]),
            "bound_ms": d["bound_ms"], "card": smi}))
    log(f"float: qmatmul_hybrid per b1 request ({len(b1)} calls): "
        f"{s['ms']:.5f} ms, plain {s['plain_ms']:.4f} ms, bound "
        f"{s['bound_ms']:.6f} ms, library {s['library_ms']:.5f} ms "
        f"({json.dumps(s['library'])}) ({smi})")
    return s


def float_phase(torch, dev, bt, K, graphs, float_goldens, smi):
    """MobileNetV2 1.0/224 fp16 and dynamic range at full width on one GPU
    worker (fixed_worker, max_batch 8), registered through the public
    API: FLOAT_WARM untimed and FLOAT_SYNC timed request_sync at b1, then
    a burst of FLOAT_BURST request_async, per model; every output meets
    float_gate against its TFLite golden.  Then, on the engine's own executor, one
    dynamic-range request in a window beside the same request scaled by
    1000 and beside an all-zero request: its output within
    ISOLATION_REL of max|output| of the request served alone.  Launch
    counts are zeroed just before and read just after: qmatmul_hybrid
    must launch, no int8 kernel.  Then the device time, launches and
    busy share of a b1 request of each model (torch.profiler)."""
    K.reset_launches()
    eng = _engine(bt, bt.DeviceFlag.GPU, "exact")
    rates, worst = {}, {}
    try:
        t0 = time.perf_counter()
        mids = {name: eng.register_model(bt.Model.from_path(
            os.path.join(DATA, f"{name}.tflite"))) for name in FLOAT_MODELS}
        check(eng.wait_buckets_ready(timeout=600),
              "float: bucket warm-up timed out")
        log(f"float: {', '.join(FLOAT_MODELS)} registered, buckets "
            f"2..{MAX_BATCH} warm in {time.perf_counter() - t0:.2f} s")
        for name, mid in mids.items():
            gd = float_goldens[name]
            xs, n = gd["xs"], len(gd["xs"])
            ex = eng.model_record(mid).executors[0]
            warm = [eng.request_sync(mid, [xs[i % n]])
                    for i in range(FLOAT_WARM)]
            t0 = time.perf_counter()
            outs = [eng.request_sync(mid, [xs[i % n]])
                    for i in range(FLOAT_SYNC)]
            b1 = FLOAT_SYNC / (time.perf_counter() - t0)
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]])
                   for i in range(FLOAT_BURST)]
            burst_outs = [eng.wait(j) for j in ids]
            burst = FLOAT_BURST / (time.perf_counter() - t0)
            served = [(i % n, o) for i, o in enumerate(warm)] + [
                (i % n, o) for i, o in enumerate(outs)] + [
                (i % n, o) for i, o in enumerate(burst_outs)]
            w = dict(dev=0.0, ratio=0.0)
            for i, (gi, o) in enumerate(served):
                check(len(o) == 1, f"float: {name}: {len(o)} outputs")
                ok, d, limit = float_gate(o[0], gd["output"][gi],
                                          gd["dev"][gi])
                check(ok, f"float: {name} request {i} (golden {gi}): top-1 "
                      f"{int(o[0].argmax())} against TFLite's "
                      f"{int(gd['output'][gi].argmax())}, deviation {d} "
                      f"against the limit {limit}")
                w["dev"] = max(w["dev"], d)
                w["ratio"] = max(w["ratio"], d / limit)
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"float: {name}: the burst ran no batch "
                  "window")
            rates[name] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            worst[name] = w
            log(f"float: {name}: {FLOAT_WARM + FLOAT_SYNC} sync and "
                f"{FLOAT_BURST} burst "
                f"outputs within the gate (top-1 equal to TFLite's; worst "
                f"deviation {w['dev']:.3e}, {w['ratio']:.3f} of its limit); "
                f"b1 {b1:.2f} req/s, burst {burst:.2f} req/s, windows "
                f"{dict(sorted(windows.items()))} ({smi})")
        # per-request quantization: a neighbour in the window moves nothing
        ex = eng.model_record(mids[DYNRANGE]).executors[0]
        key = ex.largest_subgraph_key()
        xs = float_goldens[DYNRANGE]["xs"]
        alone = ex.execute(key, [xs[0]])[0].cpu().numpy()
        for label, other in (("x1000", xs[1] * 1000.0),
                             ("all zero", np.zeros_like(xs[1]))):
            (got,), _ = ex.execute_batched(key, [[xs[0]], [other]])
            d = float(np.abs(got.cpu().numpy() - alone).max())
            check(d <= ISOLATION_REL * float(np.abs(alone).max()),
                  f"float: {DYNRANGE} beside a request {label}: moved by {d}")
            log(f"float: {DYNRANGE} beside a request {label} in its window: "
                f"max |diff| from the request alone {d:.3e} (limit "
                f"{ISOLATION_REL} x {float(np.abs(alone).max()):.3e})")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    check(counts["qmatmul_hybrid"] > 0,
          "float: kernel qmatmul_hybrid never launched on the main path")
    for name in list(KERNELS) + [ADDSUB]:
        check(counts[name] == 0,
              f"float: int8 kernel {name} launched {counts[name]} times")
    log(f"float: launches {json.dumps(counts)}")
    profiles = {}
    for name in FLOAT_MODELS:
        p = profile_phase(torch, dev, graphs, float_goldens, True, name=name)
        profiles[name] = p
        log(f"float: {name} per b1 request: device {p['device_kernel_ms']} "
            f"ms, {p['launches']} launches, busy share "
            f"{p['device_busy_share']} ({smi})")
    return counts, rates, worst


# --------------------------------------------------------------------------
# srfloat phase: FSRCNN x2 float32 and dynamic range, and the hybrid conv
# --------------------------------------------------------------------------

def _upsample(a, size, axis):
    """Bilinear resampling of ``axis`` to ``size`` samples (half-pixel
    centres, edges clamped), in float64."""
    n = a.shape[axis]
    src = np.clip((np.arange(size) + 0.5) * n / size - 0.5, 0, n - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    f = (src - lo).reshape([-1 if d == axis else 1 for d in range(a.ndim)])
    return np.take(a, lo, axis) * (1 - f) + np.take(a, hi, axis) * f


def sr_inputs(seed, n, h, w):
    """tests/gen_torch_fsrcnn_float_models.py's request frames: smooth
    float32 [n, h, w, 1] in [0, 1], numpy only (tests/test_torch_srfloat.py
    holds the two equal)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.0, 1.0, (n, max(h // 8, 2), max(w // 8, 2), 1))
    up = _upsample(_upsample(coarse, h, 1), w, 2)
    fine = rng.uniform(-0.08, 0.08, (n, h, w, 1))
    return np.clip(up + fine, 0.0, 1.0).astype(np.float32)


def load_srfloat_goldens():
    """Goldens of SRFLOAT_MODELS (tests/gen_torch_fsrcnn_float_models.py):
    the frames (from their seeds), TFLite's outputs at the stored
    positions, max|TFLite output| and the reference deviation, per
    request."""
    z = np.load(SRFLOAT_GOLDENS)
    out = {}
    for name in SRFLOAT_MODELS:
        want = z[f"{name}/tflite"]
        # [n, 1, 360, 640, 1]: each request as the model takes it
        out[name] = dict(xs=sr_inputs(int(z[f"{name}/seed"]), len(want), 360,
                                      640)[:, None],
                         positions=z["positions"], tflite=want,
                         max=z[f"{name}/max"], dev=z[f"{name}/dev"])
    return out


def srfloat_gate(out, gd, i):
    """(ok, deviation, limit) of one FSRCNN float output against golden
    request i: finite, [1, 720, 1280, 1], and at every stored position
    within max(2 x the reference deviation, 1e-4 x max|golden|)."""
    out = np.asarray(out)
    if out.shape != (1, 720, 1280, 1) or not np.isfinite(out).all():
        return False, float("inf"), 0.0
    got = out.reshape(-1)[gd["positions"]].astype(np.float64)
    d = float(np.abs(got - gd["tflite"][i]).max())
    limit = max(2.0 * float(gd["dev"][i]), 1e-4 * float(gd["max"][i]))
    return d <= limit, d, limit


def hybrid_conv_work(args, kw, out):
    """(bytes, int8 ops) of one qconv2d_hybrid call: the codes and weights
    read once, the epilogue's vectors (w_scale, colsum, bias a column; zp,
    scale an image), the float32 output written once."""
    x, w = args[0], args[1]
    vecs = [t for t in args[2:] if hasattr(t, "numel")]
    nbytes = x.numel() + w.numel() + sum(4 * t.numel() for t in vecs) \
        + 4 * out.numel()
    return nbytes, 2 * out.numel() * w.shape[0]


def hybrid_conv_library(torch, dev, graph, args):
    """qconv2d_hybrid's yardstick: one cuDNN float32 transposed conv of
    the model's deconv (its weights dequantized, TF32 off, channels-last)
    on the dequantized input of the same call.  Not the same function (no
    per-request quantization); the port never calls it."""
    import torch.nn.functional as F

    check(not torch.backends.cudnn.allow_tf32, "cuDNN with TF32")
    op = next(o for o in graph.ops if o.opname == "TRANSPOSE_CONV")
    w_td = graph.tensor(op.inputs[1])
    wf = torch.from_numpy(np.ascontiguousarray(np.transpose(
        w_td.data.astype(np.float32) * w_td.quant.scale.reshape(-1, 1, 1, 1),
        (3, 0, 1, 2)))).to(dev)
    b = torch.from_numpy(graph.tensor(op.inputs[3]).data.astype(
        np.float32)).to(dev)
    q, zp, scale = args[0], args[4], args[5]
    xf = ((q.float() - zp.reshape(-1, 1, 1, 1)) * scale.reshape(-1, 1, 1, 1)
          ).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    o = op.options
    k = int(w_td.shape[1])
    pad = (k - o["stride_h"]) // 2  # SAME, output = stride x input
    return lambda: F.conv_transpose2d(xf, wf, b, (o["stride_h"],
                                                  o["stride_w"]), pad)


def hybrid_conv_lines(torch, dev, graphs, sg, smi):
    """Every qconv2d_hybrid call of a dynamic-range FSRCNN window at b1
    and b8 (one a window: the deconv's union conv), captured from the
    model's program on the card and held byte-equal to
    qconv2d_hybrid_plain; the b1 call timed (a CUDA graph of 20
    launches) beside the plain version (eager), the bound and a cuDNN
    float32 transposed conv (hybrid_conv_library): one ``hybrid_conv:``
    line.  Returns the kernels line's numbers."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L
    from band_tpu_torch.ops.kernels import qconv as QC

    g = graphs[SR_DYNRANGE]
    xs = sg[SR_DYNRANGE]["xs"]
    prog = build_program(g, range(len(g.ops)), device=dev)
    params = params_from_jax(prog.params, dev)
    fn = prog.make_fn()
    worst, b1 = 0.0, None
    with torch.inference_mode():
        for b in (1, MAX_BATCH):
            x = torch.from_numpy(np.concatenate(
                [xs[i % len(xs)] for i in range(b)])).to(dev)
            calls = capture_calls(L, fn, params, [x])
            torch.cuda.synchronize()
            kinds = [n for n, *_ in calls]
            check(kinds == ["qconv2d_hybrid"], f"srfloat: {SR_DYNRANGE} b{b} "
                  f"ran kernels {kinds} (want one qconv2d_hybrid)")
            name, args, kw, out = calls[0]
            want = K.qconv2d_hybrid_plain(*args, **kw)
            torch.cuda.synchronize()
            worst = max(worst, same_float(torch, name, out, want,
                                          f"{SR_DYNRANGE} b{b}"))
            log(f"srfloat: {SR_DYNRANGE} b{b}: its qconv2d_hybrid call "
                f"{tuple(args[0].shape)} -> {tuple(out.shape)} byte-equal to "
                "plain (tolerance 0)")
            if b == 1:
                b1 = calls[0]
        name, args, kw, out = b1
        ms = graph_ms(torch, lambda: K.qconv2d_hybrid(*args, **kw))
        pms = eager_ms(torch, lambda: K.qconv2d_hybrid_plain(*args, **kw))
        lib = graph_ms(torch, hybrid_conv_library(torch, dev, g, args))
    nbytes, ops = hybrid_conv_work(args, kw, out)
    bt, ot = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
    x, w = args[0], args[1]
    plan = QC.hybrid_plan(x.shape[0], out.shape[1], out.shape[2], x.shape[3],
                          w.shape[1], kw["kh"], kw["kw"], (1, 1), (1, 1))
    s = dict(launches_b1=1, ms=ms, plain_ms=pms, bound_ms=max(bt, ot),
             bytes_s=bt, ops_s=ot, library_ms=lib, max_abs_err=worst)
    log("hybrid_conv: " + json.dumps({
        "shape": "x".join(map(str, x.shape)), "taps": f"{kw['kh']}x{kw['kw']}",
        "oc": int(w.shape[1]), "out": "x".join(map(str, out.shape)),
        "plan": plan.name, "blocks": plan.blocks, "smem": plan.smem,
        "ms": ms, "plain_ms": pms, "bound_ms": max(bt, ot),
        "bound_by": "bytes" if bt >= ot else "operations",
        "library": "cuDNN float32 conv_transpose2d", "library_ms": lib,
        "max_abs_err": worst, "card": smi}))
    return s


def srfloat_phase(torch, dev, bt, K, graphs, sg, smi):
    """FSRCNN x2 at 360x640 in float32 and dynamic range on one GPU worker
    (fixed_worker, max_batch 8), both through the public API: the 4
    goldens request_sync, SRFLOAT_TIMED timed request_sync and a burst of
    SRFLOAT_BURST request_async per model, every output under
    srfloat_gate; one b1 request of each under the engine's device trace
    (xprof).  Launch counts are zeroed just before and read just after:
    qconv2d_hybrid must launch, no other kernel (the 1x1 convs keep float
    weights, the rest is cuDNN).  Then the device time, launches and busy
    share of a b1 request of each model (torch.profiler), and its split by
    graph op on the executor (xprof)."""
    K.reset_launches()
    eng = _engine(bt, bt.DeviceFlag.GPU, "exact")
    rates, worst = {}, {}
    try:
        t0 = time.perf_counter()
        mids = {name: eng.register_model(bt.Model.from_path(
            os.path.join(DATA, f"{name}.tflite"))) for name in SRFLOAT_MODELS}
        check(eng.wait_buckets_ready(timeout=600),
              "srfloat: bucket warm-up timed out")
        log(f"srfloat: {', '.join(SRFLOAT_MODELS)} registered, buckets "
            f"2..{MAX_BATCH} warm in {time.perf_counter() - t0:.2f} s")
        for name, mid in mids.items():
            gd = sg[name]
            xs, n = gd["xs"], len(gd["xs"])
            ex = eng.model_record(mid).executors[0]
            served = [(i, eng.request_sync(mid, [xs[i]])) for i in range(n)]
            t0 = time.perf_counter()
            served += [(i % n, eng.request_sync(mid, [xs[i % n]]))
                       for i in range(SRFLOAT_TIMED)]
            b1 = SRFLOAT_TIMED / (time.perf_counter() - t0)
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]])
                   for i in range(SRFLOAT_BURST)]
            served += [(i % n, eng.wait(j)) for i, j in enumerate(ids)]
            burst = SRFLOAT_BURST / (time.perf_counter() - t0)
            w = dict(dev=0.0, ratio=0.0)
            for k, (gi, o) in enumerate(served):
                check(len(o) == 1, f"srfloat: {name}: {len(o)} outputs")
                ok, d, limit = srfloat_gate(o[0], gd, gi)
                check(ok, f"srfloat: {name} request {k} (golden {gi}): "
                      f"deviation {d} against the limit {limit}")
                w["dev"] = max(w["dev"], d)
                w["ratio"] = max(w["ratio"], d / limit)
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"srfloat: {name}: the burst ran no batch "
                  "window")
            rates[name] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            worst[name] = w
            log(f"srfloat: {name}: {n + SRFLOAT_TIMED} sync and "
                f"{SRFLOAT_BURST} burst outputs (720x1280) within the gate "
                f"(worst deviation {w['dev']:.3e}, {w['ratio']:.3f} of its "
                f"limit); b1 {b1:.2f} req/s, burst {burst:.2f} req/s, "
                f"windows {dict(sorted(windows.items()))} ({smi})")
        for name, mid in mids.items():
            gd = sg[name]
            engine_xprof(eng, mid, gd["xs"][0],
                         lambda o, gd=gd: srfloat_gate(o, gd, 0)[0],
                         f"{name} b1 (engine)", smi)
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    for name in K.LAUNCHES:
        check((counts[name] > 0) == (name in HYBRID_CONV_KERNELS),
              f"srfloat: kernel {name} launched {counts[name]} times")
    log(f"srfloat: launches {json.dumps(counts)}")
    profiles = {}
    for name in SRFLOAT_MODELS:
        p = profile_phase(torch, dev, graphs, sg, True, name=name, xprof=smi)
        profiles[name] = {k: p[k] for k in ("executor_wall_ms",
                                            "device_kernel_ms",
                                            "device_busy_share", "launches")}
        log(f"srfloat: {name} per b1 request: device "
            f"{p['device_kernel_ms']} ms, {p['launches']} launches, busy "
            f"share {p['device_busy_share']} ({smi})")
    return counts, rates, worst, profiles


# --------------------------------------------------------------------------
# detect phase: CenterNet MobileNetV2 FPN 512x512 int8 and its decode
# --------------------------------------------------------------------------

def load_detect_goldens(graphs):
    """Goldens of DETECT_MODEL (tests/gen_torch_centernet_model.py): xs
    (regenerated from the seed and checked against the stored digest);
    per output, TFLite's exact and band_tpu's fast outputs."""
    z = np.load(DETECT_GOLDENS)
    g = graphs[DETECT_MODEL]
    n_out = len(g.outputs)
    exact = [z[f"{DETECT_MODEL}/exact{j}"] for j in range(n_out)]
    fast = [z[f"{DETECT_MODEL}/fast{j}"] for j in range(n_out)]
    return dict(xs=_inputs(z, DETECT_MODEL, g, len(exact[0])), exact=exact,
                fast=fast)


def _same_detections(outs, want, i, what):
    """One request's boxes, scores and classes against golden request i."""
    check(len(outs) == len(want), f"{what}: {len(outs)} outputs")
    for j, (o, w) in enumerate(zip(outs, want)):
        o = o.cpu().numpy() if hasattr(o, "cpu") else np.asarray(o)
        check(o.dtype == w.dtype and o.shape == w[i].shape
              and np.array_equal(o, w[i]),
              f"{what} request {i} output {j}: differs from the golden")


def detect_calls(torch, dev, graphs, dg, plain, worst):
    """Every kernel call of the full-width CenterNet at b1 and in a b8
    window, exact and fast, held byte-equal to plain, and the outputs
    there equal to the goldens.  Returns the b1 calls by numerics."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import lowerings as L

    g = graphs[DETECT_MODEL]
    pos = None
    b1_calls = {}
    for kind in ("exact", "fast"):
        exact = kind == "exact"
        prog = build_program(g, range(len(g.ops)), exact=exact, device=dev)
        params = params_from_jax(prog.params, dev)
        fn = prog.make_fn()
        pos = [prog.output_ids.index(t) for t in g.outputs]
        for b in (1, MAX_BATCH):
            x = torch.from_numpy(np.concatenate(list(dg["xs"][:b]))).to(dev)
            calls = capture_calls(L, fn, params, [x])
            torch.cuda.synchronize()
            for kname, args, kw, out in calls:
                want = plain[kname](*args, **kw)
                torch.cuda.synchronize()
                held(torch, worst, kname, args, kw, out, want,
                     f"{DETECT_MODEL} {kind} b{b} {tuple(args[0].shape)}")
            check(not any(n in (FAST if exact else EXACT_ONLY)
                          for n, *_ in calls),
                  f"{DETECT_MODEL} {kind}: a kernel of the other numerics")
            outs = fn(params, [x])
            for i in range(b):
                _same_detections([outs[p][i:i + 1] for p in pos], dg[kind],
                                 i, f"kernels: {DETECT_MODEL} {kind} b{b}")
            if b == 1:
                b1_calls[kind] = calls
            used = collections.Counter(n for n, *_ in calls)
            log(f"kernels: {DETECT_MODEL} {kind} b{b}: {len(calls)} calls "
                f"{dict(used)} byte-equal to plain (tolerance 0); the "
                "outputs equal to the goldens")
            del calls, outs
            torch.cuda.empty_cache()
    return b1_calls


def detect_kernel_lines(torch, b1_calls, smi):
    """One ``detect_kernels:`` line per numerics: each kernel's b1 calls
    of a CenterNet request (B2's mma branch apart), their summed time (a
    CUDA graph of 20 launches, replayed), the plain versions' (eager)
    and the bound."""
    from band_tpu_torch.ops import kernels as K

    plain = {"qmatmul_exact": K.qmatmul_plain,
             "qconv2d_exact": K.qconv2d_plain,
             "qdwconv2d_exact": K.qdwconv2d_plain,
             "qmatmul_fast": K.qmatmul_fast_plain,
             "qconv2d_fast": K.qconv2d_fast_plain,
             "qdwconv2d_fast": K.qdwconv2d_fast_plain}
    smallest = None
    for kind, calls in b1_calls.items():
        rows = {}
        for name, args, kw, out in calls:
            label = name
            if (name in ("qconv2d_exact", "qconv2d_fast")
                    and b2_plan(args, kw, out).branch == "mma"):
                label = name + "_mma"
            ms = graph_ms(torch, lambda: getattr(K, name)(*args, **kw))
            r = rows.setdefault(label, dict(calls=0, ms=0.0, plain_ms=0.0,
                                            bound_ms=0.0, min_call_ms=None))
            r["calls"] += 1
            r["ms"] += ms
            r["plain_ms"] += eager_ms(torch, lambda: plain[name](*args, **kw),
                                      iters=2)
            r["bound_ms"] += bound_ms(name, args, kw, out)
            r["min_call_ms"] = ms if r["min_call_ms"] is None else min(
                r["min_call_ms"], ms)
            if kind == "exact":
                smallest = ms if smallest is None else min(smallest, ms)
        log("detect_kernels: " + json.dumps({
            "model": DETECT_MODEL, "numerics": kind, "batch": 1,
            "kernels": rows, "total_ms": sum(r["ms"] for r in rows.values()),
            "card": smi}))
    return smallest


def _decode_ops(g):
    """The decode's ops: from the heatmap's max pool on, but the heads'
    convs (the converter interleaves them)."""
    start = next(op.index for op in g.ops if op.opname == "MAX_POOL_2D")
    return [op.index for op in g.ops[start:]
            if op.opname not in ("CONV_2D", "DEPTHWISE_CONV_2D")]


def detect_decode_lines(torch, dev, graphs, dg, smi, smallest_ms):
    """The decode's device time apart from the backbone and heads: the
    network up to the heads runs once on a golden request, then each
    decode op alone, 20 times under torch.profiler: its kernels' device
    time and launches, summed by op type.  The decode as one program
    must give the goldens."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops.lowerings import LowerCtx
    from band_tpu_torch.ops.registry import get_lowering

    g = graphs[DETECT_MODEL]
    decode = _decode_ops(g)
    net = [i for i in range(len(g.ops)) if i not in set(decode)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    result = {}
    for kind in ("exact", "fast"):
        exact = kind == "exact"
        head = build_program(g, net, exact=exact, device=dev)
        tail = build_program(g, decode, exact=exact, device=dev)
        x = torch.from_numpy(dg["xs"][0]).to(dev)
        hv = dict(zip(head.output_ids, head.make_fn()(
            params_from_jax(head.params, dev), [x])))
        tparams = params_from_jax(tail.params, dev)
        outs = tail.make_fn()(tparams, [hv[t] for t in tail.input_ids])
        pos = [tail.output_ids.index(t) for t in g.outputs]
        _same_detections([outs[p] for p in pos], dg[kind], 0,
                         f"detect: decode {kind}")
        ctx = LowerCtx(g, tparams, tail.meta)
        for t in tail.input_ids:
            ctx.set(t, hv[t])
        by_type = {}
        reps = 20
        for oi in decode:
            op = g.ops[oi]
            low = get_lowering(op.opname)
            low.trace(ctx, op)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(reps):
                    low.trace(ctx, op)
                torch.cuda.synchronize()
            ms, n = 0.0, 0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and \
                        not annotation(e):
                    ms += e.self_device_time_total / 1e3 / reps
                    n += e.count
            r = by_type.setdefault(op.opname, dict(ops=0, ms=0.0,
                                                   launches=0))
            r["ops"] += 1
            r["ms"] += ms
            r["launches"] += round(n / reps)
        total = sum(r["ms"] for r in by_type.values())
        result[kind] = dict(ms=total, launches=sum(
            r["launches"] for r in by_type.values()))
        log("detect_decode: " + json.dumps({
            "model": DETECT_MODEL, "numerics": kind, "batch": 1,
            "decode_ops": len(decode), "device_ms": total,
            "launches": result[kind]["launches"],
            "by_op": dict(sorted(by_type.items(), key=lambda kv: -kv[1]["ms"])),
            "smallest_backbone_kernel_ms": smallest_ms, "card": smi}))
    return result


def detect_ties(torch, dev, graphs, smi):
    """TOPK_V2 of the full-width decode on the card: an all-tied heatmap
    row (1,474,560 int8 values) gives indices 0..99 in order; a window of
    two tied rows at other values the same per request; a row of three
    distinct values the CPU's indices (lower index first among equals)."""
    from band_tpu_torch.backend.program import build_program, params_from_jax

    g = graphs[DETECT_MODEL]
    op = next(o for o in g.ops if o.opname == "TOPK_V2")
    n = int(g.tensor(op.inputs[0]).shape[-1])
    k = int(np.asarray(g.tensor(op.inputs[1]).data).reshape(()))
    prog = build_program(g, [op.index], device=dev)
    fn = prog.make_fn()
    params = {d: params_from_jax(prog.params, d) for d in (dev, "cpu")}
    rows = {"tied": np.full((1, n), 3, np.int8),
            "window": np.stack([np.full(n, -128, np.int8),
                                np.full(n, 127, np.int8)]),
            "three values": np.random.default_rng(9).integers(
                -1, 2, (1, n)).astype(np.int8)}
    for what, row in rows.items():
        vals, idx = fn(params[dev], [torch.from_numpy(row).to(dev)])
        cvals, cidx = fn(params["cpu"], [torch.from_numpy(row)])
        idx = idx.cpu().numpy()
        check(np.array_equal(idx, cidx.numpy())
              and np.array_equal(vals.cpu().numpy(), cvals.numpy()),
              f"detect: TOPK_V2 {what} on the card differs from the CPU")
        for b in range(row.shape[0]):
            order = np.lexsort((np.arange(n), -row[b].astype(np.int64)))[:k]
            check(np.array_equal(idx[b], order),
                  f"detect: TOPK_V2 {what} row {b}: indices not in index "
                  "order among ties")
    check(np.array_equal(fn(params[dev], [torch.from_numpy(
        rows["tied"]).to(dev)])[1].cpu().numpy()[0], np.arange(k)),
        "detect: an all-tied row's top-k is not 0..k-1")
    log(f"detect: TOPK_V2 on the card ({n} values, k = {k}): an all-tied "
        f"row gives indices 0..{k - 1} in order, a window of two tied rows "
        "and a row of three values the CPU's indices, lower index first "
        f"among equals ({smi})")


def detect_phase(torch, dev, bt, K, graphs, dg, smi):
    """The full-width CenterNet on one GPU worker (fixed_worker, max_batch
    8), registered twice, exact and register_model(numerics="fast"):
    every golden request at b1 (request_sync), DETECT_SYNC timed b1
    requests after them, and a burst of DETECT_BURST request_async, in
    each numerics, every output byte-equal to its golden (TFLite's exact,
    band_tpu's fast).  On an executor of the model, the 8 golden requests
    as one b8 window, and the same window in reversed order, equal to the
    goldens request by request (each request's GATHER_ND reads its own
    maps).  Launch counts are zeroed just before and read just after:
    B1, B2 (direct and mma), B3 and their fast instances must launch, not
    the softmax or the hybrid GEMM.  Then TOPK_V2's ties on the card, the
    device time, launches and busy share of a b1 request (torch.profiler),
    the kernels' b1 times and the decode's device time."""
    from band_tpu_torch.backend.executor import ModelExecutor

    K.reset_launches()
    eng = _engine(bt, bt.DeviceFlag.GPU, "exact")
    xs, n = dg["xs"], len(dg["xs"])
    rates = {}
    try:
        path = os.path.join(DATA, f"{DETECT_MODEL}.tflite")
        t0 = time.perf_counter()
        mids = {"exact": eng.register_model(bt.Model.from_path(path)),
                "fast": eng.register_model(bt.Model.from_path(path),
                                           numerics="fast")}
        check(eng.wait_buckets_ready(timeout=600),
              "detect: bucket warm-up timed out")
        log(f"detect: {DETECT_MODEL} registered exact and fast, buckets "
            f"2..{MAX_BATCH} warm in {time.perf_counter() - t0:.2f} s")
        for kind, mid in mids.items():
            want = dg[kind]
            ex = eng.model_record(mid).executors[0]
            check(ex.exact == (kind == "exact"), f"detect: {kind} numerics")
            for i in range(n):
                _same_detections(eng.request_sync(mid, [xs[i]]), want, i,
                                 f"detect: {kind} b1")
            t0 = time.perf_counter()
            outs = [eng.request_sync(mid, [xs[i % n]])
                    for i in range(DETECT_SYNC)]
            b1 = DETECT_SYNC / (time.perf_counter() - t0)
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]])
                   for i in range(DETECT_BURST)]
            burst_outs = [eng.wait(j) for j in ids]
            burst = DETECT_BURST / (time.perf_counter() - t0)
            for i, o in enumerate(outs):
                _same_detections(o, want, i % n, f"detect: {kind} sync")
            for i, o in enumerate(burst_outs):
                _same_detections(o, want, i % n, f"detect: {kind} burst")
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"detect {kind}: the burst ran no batch "
                  "window")
            rates[kind] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            log(f"detect: {kind}: {n} golden b1 requests, {DETECT_SYNC} sync "
                f"and {DETECT_BURST} burst byte-equal to the goldens (boxes, "
                f"scores, classes); b1 {b1:.2f} req/s, burst {burst:.2f} "
                f"req/s, windows {dict(sorted(windows.items()))} ({smi})")
        for kind in ("exact", "fast"):
            wex = ModelExecutor(-4, graphs[DETECT_MODEL], 0, dev,
                                exact=kind == "exact")
            key = wex.prepare_subgraph(range(len(graphs[DETECT_MODEL].ops)),
                                       [0])
            pos = [wex.output_ids(key).index(t)
                   for t in graphs[DETECT_MODEL].outputs]
            for order in (list(range(n)), list(reversed(range(n)))):
                outs = wex.execute_batched(key, [[xs[i]] for i in order])
                for i, o in zip(order, outs):
                    _same_detections([o[p] for p in pos], dg[kind], i,
                                     f"detect: {kind} b{n} window {order}")
            log(f"detect: {kind}: the {n} golden requests as one b{n} "
                "window, and reversed, equal to the goldens request by "
                "request")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    ran = EXACT_ONLY + FAST + tuple(MMA_KERNELS) + (ADDSUB,)
    for name in K.LAUNCHES:
        check((counts[name] > 0) == (name in ran),
              f"detect: kernel {name} launched {counts[name]} times")
    log(f"detect: launches {json.dumps(counts)}")
    detect_ties(torch, dev, graphs, smi)
    profiles = {}
    for kind in ("exact", "fast"):
        p = profile_phase(torch, dev, graphs, {DETECT_MODEL: dg},
                          kind == "exact", name=DETECT_MODEL)
        profiles[kind] = {k: p[k] for k in ("executor_wall_ms",
                                            "device_kernel_ms",
                                            "device_busy_share", "launches")}
        log(f"detect: {kind} per b1 request: device {p['device_kernel_ms']} "
            f"ms, {p['launches']} launches, busy share "
            f"{p['device_busy_share']} ({smi})")
    return counts, rates, profiles


# --------------------------------------------------------------------------
# seq phase: the Keras IMDB bidirectional LSTM, fused and as WHILE loops
# --------------------------------------------------------------------------

def seq_paths():
    """The full-width IMDB models, unpacked from tests/data/
    imdb_bilstm.tar.xz (both files share one embedding table) into
    band_tpu_torch/_build/data once; their paths by name."""
    import tarfile

    dest = os.path.join(ROOT, "band_tpu_torch", "_build", "data")
    os.makedirs(dest, exist_ok=True)
    paths = {n: os.path.join(dest, f"{n}.tflite") for n in SEQ_MODELS}
    if not all(os.path.exists(p) for p in paths.values()):
        with tarfile.open(SEQ_ARCHIVE, "r:xz") as tar:
            tar.extractall(dest, filter="data")
    return paths


def seq_order(g):
    """A model's output positions, smallest first: the sigmoid, then the
    first BiLSTM's sequence (the two conversions order them apart)."""
    return sorted(range(len(g.outputs)),
                  key=lambda k: int(np.prod(g.tensor(g.outputs[k]).shape)))


def load_seq_goldens(graphs):
    """tests/data/torch_seq_goldens.npz (tests/gen_torch_seq_models.py):
    the reviews, and per IMDB model TFLite's outputs (a fresh interpreter
    for each request) and band_tpu's, in seq_order; lstm_seq_int8's inputs
    and TFLite outputs."""
    z = np.load(SEQ_GOLDENS)
    out = {"xs": z["xs"], "int8_xs": z[f"{SEQ_INT8}/xs"],
           "int8": z[f"{SEQ_INT8}/tflite"]}
    for name in SEQ_MODELS:
        order = seq_order(graphs[name])
        out[name] = {src: [z[f"{name}/{src}/{k}"] for k in order]
                     for src in ("tflite", "band")}
    return out


def seq_limit(gd, k, i):
    """The float gate's bound on output k of golden request i: max(2 x
    band_tpu's deviation from TFLite there, 1e-4 x max|golden|)."""
    want = gd["tflite"][k][i].astype(np.float64)
    band = float(np.abs(gd["band"][k][i] - want).max())
    return want, max(2.0 * band, 1e-4 * float(np.abs(want).max()))


def seq_gate(outs, gd, i):
    """(ok, worst deviation over its bound, message) of one request's
    outputs (seq_order) under the float gate against golden request i:
    each within seq_limit, and the sigmoid's decision (> 0.5) TFLite's."""
    worst, msgs = 0.0, []
    for k, o in enumerate(outs):
        want, limit = seq_limit(gd, k, i)
        o = np.asarray(o, np.float64).reshape(want.shape)
        d = float(np.abs(o - want).max())
        worst = max(worst, d / limit)
        if d > limit:
            msgs.append(f"output {k} deviates {d:.3e} > {limit:.3e}")
        if k == 0 and not np.array_equal(o > 0.5, want > 0.5):
            msgs.append(f"decision {o.ravel()} against TFLite's "
                        f"{want.ravel()}")
    return not msgs, worst, "; ".join(msgs)


def seq_calls(torch, dev, graphs, sg, plain, worst):
    """Every kernel call of lstm_seq_int8 (its int8 Dense head on B1 or
    B4, the softmax) at b1 and in a b8 window, exact and fast, held
    byte-equal to plain, and the outputs within 1 LSB of TFLite's."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import lowerings as L

    g = graphs[SEQ_INT8]
    for kind in ("exact", "fast"):
        exact = kind == "exact"
        prog = build_program(g, range(len(g.ops)), exact=exact, device=dev)
        params = params_from_jax(prog.params, dev)
        fn = prog.make_fn()
        for b in (1, MAX_BATCH):
            x = torch.from_numpy(np.concatenate(list(sg["int8_xs"][:b]))).to(
                dev)
            calls = capture_calls(L, fn, params, [x])
            torch.cuda.synchronize()
            for kname, args, kw, out in calls:
                want = plain[kname](*args, **kw)
                torch.cuda.synchronize()
                held(torch, worst, kname, args, kw, out, want,
                     f"{SEQ_INT8} {kind} b{b} {tuple(args[0].shape)}")
            (out,) = fn(params, [x])
            d = np.abs(out.cpu().numpy().astype(np.int32) - np.concatenate(
                list(sg["int8"][:b])).astype(np.int32)).max()
            check(d <= 1, f"kernels: {SEQ_INT8} {kind} b{b}: {d} LSB from "
                  "TFLite")
            used = collections.Counter(n for n, *_ in calls)
            log(f"kernels: {SEQ_INT8} {kind} b{b}: {len(calls)} calls "
                f"{dict(used)} byte-equal to plain (tolerance 0); the "
                f"outputs within {d} LSB of TFLite's")


def seq_profile(torch, dev, graphs, sg, name, smi):
    """A b1 request of ``name`` through the executor: wall time, device
    time and launches (torch.profiler), host syncs (aten::
    _local_scalar_dense: a value read on the host), busy share, and the
    share of the device time spent in the recurrences (the lowerings'
    LSTM_STEPS and WHILE_ITERATIONS ranges)."""
    from band_tpu_torch.backend.executor import ModelExecutor
    from band_tpu_torch.ops import lowerings as L

    g = graphs[name]
    ex = ModelExecutor(-5, g, 0, dev)
    key = ex.prepare_subgraph(range(len(g.ops)), [0])
    x = sg["xs"][0]
    reps = 5
    for _ in range(2):
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
    # the ranges also appear on the device's timeline as annotations that
    # span their kernels: they mark which kernels are the recurrence's,
    # and are not kernels themselves
    ranges = (L.LSTM_STEPS, L.WHILE_ITERATIONS)
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in evs
             if e.device_type == cuda and e.name in ranges]
    kernels = [e for e in evs if e.device_type == cuda
               and not annotation(e)]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    loop_ms = sum(e.time_range.elapsed_us() for e in kernels if any(
        a <= e.time_range.start < b for a, b in spans)) / 1e3 / reps
    launches = len(kernels)
    syncs = sum(1 for e in evs if e.name == "aten::_local_scalar_dense")
    measured = device_ms > 0
    out = {
        "model": name, "batch": 1, "executor_wall_ms": wall_ms,
        "device_kernel_ms": device_ms if measured else "not measured",
        "device_busy_share": (device_ms / wall_ms if measured
                              else "not measured"),
        "launches": launches // reps, "host_syncs": syncs // reps,
        "recurrence_device_share": (loop_ms / device_ms if measured
                                    and loop_ms > 0 else "not measured"),
    }
    log(f"seq_profile: {json.dumps(out)} ({smi})")
    return out


def seq_codispatch(bt, sg, graphs, smi):
    """A co_dispatch worker (max_batch 8, co_dispatch 2) serving the WHILE
    and the fused IMDB model interleaved: warm_co_dispatch refuses the
    mix (the WHILE program is not capturable), no combined program is
    built, the worker counts the windows it served unfused, and every
    output is within the gate."""
    eng = bt.Engine.create(
        bt.RuntimeConfigBuilder()
        .add_scheduler(bt.SchedulerType.FIXED_WORKER)
        .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU, device_ids=(0,),
                                  max_batch=MAX_BATCH, co_dispatch=2,
                                  dispatch_depth=4))
        .build())
    try:
        eng.co_warm_miss_threshold = 1
        mids = [eng.register_model(bt.Model.from_path(sg["paths"][n]))
                for n in SEQ_MODELS]
        check(eng.wait_buckets_ready(timeout=900),
              "seq: co-dispatch bucket warm-up timed out")
        check(not eng.warm_co_dispatch(mids, batch=2, timeout=60),
              "seq: a co-dispatch mix holding a WHILE model was captured")
        w = eng.workers[0]
        w.pause()
        jobs = []
        for r in range(2):
            for name, mid in zip(SEQ_MODELS, mids):
                idx = [(2 * r + j) % len(sg["xs"]) for j in range(2)]
                ids = eng.request_async_batch(
                    [mid] * 2, [[sg["xs"][i]] for i in idx])
                jobs += [(j, name, i) for j, i in zip(ids, idx)]
        w.resume()
        for j, name, i in jobs:
            order = seq_order(graphs[name])
            o = eng.wait(j)
            ok, _, msg = seq_gate([o[p] for p in order], sg[name], i)
            check(ok, f"seq: co-dispatch {name} golden {i}: {msg}")
        check(w.uncapturable_windows > 0,
              "seq: the worker counted no window served unfused")
        check(eng.co_dispatch_count == 0 and not eng._combo_fns,
              "seq: a combined program was built or served")
        log(f"seq: co_dispatch 2 worker with {' + '.join(SEQ_MODELS)}: "
            f"warm_co_dispatch refused, no combined program, "
            f"{w.uncapturable_windows} windows served unfused, "
            f"{len(jobs)} outputs within the gate ({smi})")
        return w.uncapturable_windows
    finally:
        eng.shutdown()


def seq_phase(torch, dev, bt, K, graphs, sg, smi):
    """The full-width IMDB classifier, fused and as WHILE loops, and
    lstm_seq_int8 exact and fast, on one GPU worker (fixed_worker,
    max_batch 8) through the public API.  Each IMDB model: the golden
    reviews at b1 (request_sync, timed) and a burst of SEQ_BURST
    request_async, every output under the float gate (seq_gate); the two
    conversions within the gate of each other on every golden review; on
    the engine's executor the 8 golden reviews as one b8 window, in order
    and reversed, under the gate and within its bound of the same review
    alone.  lstm_seq_int8: the golden inputs at b1 and as a burst, exact
    and fast, within 1 LSB of TFLite.  Launch counts zeroed just before
    and read just after: B1, B4 and lut_softmax must launch (the int8
    model's head), no other kernel.  Then the capture check
    (seq_codispatch) and a b1 request's profile of each IMDB model."""
    K.reset_launches()
    eng = _engine(bt, bt.DeviceFlag.GPU, "exact")
    xs, n = sg["xs"], len(sg["xs"])
    rates, worst, solo = {}, {}, {}
    try:
        t0 = time.perf_counter()
        mids = {name: eng.register_model(bt.Model.from_path(
            sg["paths"][name])) for name in SEQ_MODELS}
        i8 = os.path.join(DATA, f"{SEQ_INT8}.tflite")
        mids["exact"] = eng.register_model(bt.Model.from_path(i8))
        mids["fast"] = eng.register_model(bt.Model.from_path(i8),
                                          numerics="fast")
        check(eng.wait_buckets_ready(timeout=900),
              "seq: bucket warm-up timed out")
        log(f"seq: {', '.join(SEQ_MODELS)} and {SEQ_INT8} (exact, fast) "
            f"registered, buckets 2..{MAX_BATCH} warm in "
            f"{time.perf_counter() - t0:.2f} s")
        for name in SEQ_MODELS:
            mid, order = mids[name], seq_order(graphs[name])
            ex = eng.model_record(mid).executors[0]
            t0 = time.perf_counter()
            outs = [eng.request_sync(mid, [xs[i]]) for i in range(n)]
            b1 = n / (time.perf_counter() - t0)
            before = dict(ex.windows)
            t0 = time.perf_counter()
            ids = [eng.request_async(mid, [xs[i % n]])
                   for i in range(SEQ_BURST)]
            burst_outs = [eng.wait(j) for j in ids]
            burst = SEQ_BURST / (time.perf_counter() - t0)
            w = 0.0
            for i, o in enumerate(outs + burst_outs):
                ok, ratio, msg = seq_gate([o[p] for p in order], sg[name],
                                          i % n)
                check(ok, f"seq: {name} request {i} (golden {i % n}): {msg}")
                w = max(w, ratio)
            windows = {b: c - before.get(b, 0) for b, c in ex.windows.items()
                       if c - before.get(b, 0)}
            check(max(windows) > 1, f"seq: {name}: the burst ran no batch "
                  "window")
            solo[name] = [[np.asarray(o[p]) for p in order] for o in outs]
            rates[name] = dict(b1_req_s=b1, burst_req_s=burst,
                               burst_windows=dict(sorted(windows.items())))
            log(f"seq: {name}: {n} sync and {SEQ_BURST} burst outputs "
                f"within the gate (worst {w:.3f} of its bound; decisions "
                f"TFLite's); b1 {b1:.3f} req/s, burst {burst:.3f} req/s, "
                f"windows {dict(sorted(windows.items()))} ({smi})")
            worst[name] = w
        a, b = (solo[m] for m in SEQ_MODELS)
        cross = 0.0
        for i in range(n):
            for k in range(len(a[i])):
                want, limit = seq_limit(sg[SEQ_MODELS[0]], k, i)
                d = float(np.abs(a[i][k].astype(np.float64).reshape(
                    want.shape) - b[i][k].reshape(want.shape)).max())
                check(d <= limit, f"seq: the conversions differ by {d} on "
                      f"golden {i} output {k} (bound {limit})")
                cross = max(cross, d / limit)
        worst["fused_vs_while"] = cross
        log(f"seq: fused and WHILE conversions agree on every golden review "
            f"(worst {cross:.3f} of the gate's bound)")
        for name in SEQ_MODELS:
            ex = eng.model_record(mids[name]).executors[0]
            key = ex.largest_subgraph_key()
            pos = [ex.output_ids(key).index(graphs[name].outputs[p])
                   for p in seq_order(graphs[name])]
            for order in (list(range(n)), list(reversed(range(n)))):
                outs = ex.execute_batched(key, [[xs[i]] for i in order])
                for i, o in zip(order, outs):
                    got = [o[p].cpu().numpy() for p in pos]
                    ok, _, msg = seq_gate(got, sg[name], i)
                    check(ok, f"seq: {name} b{n} window {order} golden {i}: "
                          f"{msg}")
                    for k, (g_, s_) in enumerate(zip(got, solo[name][i])):
                        _, limit = seq_limit(sg[name], k, i)
                        d = float(np.abs(g_.astype(np.float64).reshape(
                            s_.shape) - s_).max())
                        check(d <= limit, f"seq: {name} golden {i} in a "
                              f"window moved {d} from alone (bound {limit})")
            log(f"seq: {name}: the {n} golden reviews as one b{n} window, "
                "and reversed, under the gate and within its bound of each "
                "review alone")
        for kind in ("exact", "fast"):
            mid = mids[kind]
            outs = [eng.request_sync(mid, [sg["int8_xs"][i]])
                    for i in range(n)]
            ids = [eng.request_async(mid, [sg["int8_xs"][i]])
                   for i in range(n)]
            outs += [eng.wait(j) for j in ids]
            d = max(int(np.abs(np.asarray(o[0]).astype(np.int32)
                               - sg["int8"][i % n].astype(np.int32)).max())
                    for i, o in enumerate(outs))
            check(d <= 1, f"seq: {SEQ_INT8} {kind}: {d} LSB from TFLite")
            log(f"seq: {SEQ_INT8} {kind}: {n} sync and {n} burst outputs "
                f"within {d} LSB of TFLite's")
    finally:
        eng.shutdown()
    counts = K.launch_counts()
    for name in K.LAUNCHES:
        check((counts[name] > 0) == (name in SEQ_RAN),
              f"seq: kernel {name} launched {counts[name]} times")
    log(f"seq: launches {json.dumps(counts)}")
    unfused = seq_codispatch(bt, sg, graphs, smi)
    profiles = {name: seq_profile(torch, dev, graphs, sg, name, smi)
                for name in SEQ_MODELS}
    return counts, rates, profiles, worst, unfused


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
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not annotation(e)) / 1e3
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


# --------------------------------------------------------------------------
# frontend phase: camera frames through the data plane, the engine, the
# HTTP server, the router and the C ABI
# --------------------------------------------------------------------------

def load_frontend_goldens():
    """tests/gen_torch_frontend_goldens.py's file: frame seeds and
    formats, each frame's digest, band_tpu's AutoConvert tensor of it and
    TFLite's output on that tensor."""
    z = np.load(FRONTEND_GOLDENS)
    return {k: z[k] for k in ("seeds", "formats", "frame_sha", "tensors",
                              "outputs")}


def frontend_frames(fg):
    """The golden frames, regenerated on this host and checked against
    their digests: [(format, Buffer)]."""
    from band_tpu_torch.buffer.buffer import BufferFormat
    from band_tpu_torch.buffer.synthetic import camera_frame, frame_digest

    fmts = {"rgb": BufferFormat.RGB, "nv12": BufferFormat.NV12}
    frames = []
    for seed, fmt, sha in zip(fg["seeds"], fg["formats"], fg["frame_sha"]):
        buf = camera_frame(int(seed), FRAME_W, FRAME_H, fmts[str(fmt)])
        check(frame_digest(buf) == str(sha),
              f"frontend: frame {seed} regenerates to other bytes here")
        frames.append((str(fmt), buf))
    return frames


def code_distance(a, b):
    """Largest distance between two int8 tensors' bytes, mod 256: the
    data-type convert wraps uint8 codes into int8 (ROADMAP Watch), so a
    resize's 127 against 128 shows as 127 against -128."""
    d = (a.view(np.uint8).astype(np.int16) - b.view(np.uint8)) % 256
    return int(np.minimum(d, 256 - d).max())


def frontend_dataplane(fg, frames, smi):
    """Gate 1: every frame through the port's AutoConvert pipeline, the
    native kernels and the numpy paths, within 1 code of band_tpu's
    golden tensor (the share of differing bytes printed); host ms per
    1080p frame of each format; preprocess_bench's table.  Returns the
    native tensors (the card-processed tensors of the later gates) and
    the host ms per frame by format."""
    from band_tpu_torch.buffer.processor import ImageProcessorBuilder
    from band_tpu_torch.tools import preprocess_bench

    shape = tuple(int(s) for s in fg["tensors"].shape[1:])
    proc = ImageProcessorBuilder().add_auto_convert(shape, np.int8).build()
    tensors, shares = [], {"native": [], "numpy": []}
    for i, (fmt, buf) in enumerate(frames):
        for path in ("native", "numpy"):
            t = proc.to_tensor(buf, native=path == "native")
            check(t.shape == shape and t.dtype == np.int8,
                  f"frontend: frame {i} {path}: {t.dtype}{t.shape}")
            d = code_distance(t, fg["tensors"][i])
            check(d <= 1, f"frontend: frame {i} ({fmt}) {path} path {d} "
                  "codes from band_tpu's tensor")
            shares[path].append(float((t != fg["tensors"][i]).mean()))
            if path == "native":
                tensors.append(t)
    log("frontend_dataplane: " + json.dumps({
        "frames": len(frames), "max_codes_from_golden": 1,
        "differing_share": shares}) + " (host CPU)")
    host_ms = {}
    for fmt in ("rgb", "nv12"):
        buf = next(b for f, b in frames if f == fmt)
        proc.to_tensor(buf)
        t0 = time.perf_counter()
        for _ in range(FRONTEND_HOST_REPS):
            proc.to_tensor(buf)
        host_ms[fmt] = 1e3 * (time.perf_counter() - t0) / FRONTEND_HOST_REPS
    log("frontend_host_ms_per_frame: " + json.dumps(host_ms)
        + f" (1080p -> int8 224x224, one host core; {smi})")
    table = {r["op"]: r["mb_s"] for r in preprocess_bench.run_all(0.2)}
    log("frontend_preprocess_bench: " + json.dumps(table)
        + " (MB/s of input, the host CPU's, not the card's)")
    return tensors, host_ms


def _http(url, method="GET", body=None, timeout=120):
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _frontend_config(bt):
    return (bt.RuntimeConfigBuilder()
            .add_scheduler(bt.SchedulerType.FIXED_WORKER)
            .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                      device_ids=(0,), max_batch=MAX_BATCH))
            .build())


def _served(send, xs, want, what):
    """Serve each of xs through ``send`` (tensor -> output array) and
    hold it byte-equal to want."""
    for i, x in enumerate(xs):
        got = send(x)
        check(got.dtype == want[i].dtype and np.array_equal(got, want[i]),
              f"frontend: {what} request {i} differs")


def _rate(send, x):
    """b1 closed loop: FRONTEND_TIMED sends back to back after two."""
    send(x)
    send(x)
    t0 = time.perf_counter()
    for _ in range(FRONTEND_TIMED):
        send(x)
    return FRONTEND_TIMED / (time.perf_counter() - t0)


def frontend_http(bt, fg, card, card_ref, smi):
    """HTTP POST /request (sync, and async + POST /wait) on the golden
    and the card-processed tensors, the b1 rate, and the hot swap."""
    from band_tpu_torch.tools.server import decode_tensor, encode_tensor, serve

    es, httpd = serve(_frontend_config(bt), port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, reg = _http(f"{url}/models", "POST", {"path": FRONTEND_PATH})
        check(code == 200, f"frontend: HTTP register: {code} {reg}")
        mid = reg["model_id"]

        def send(x):
            code, out = _http(f"{url}/request", "POST", {
                "model_id": mid, "inputs": [encode_tensor(x)]})
            check(code == 200, f"frontend: HTTP request: {code} {out}")
            return decode_tensor(out["outputs"][0])

        _served(send, fg["tensors"], fg["outputs"], "HTTP sync golden")
        jobs = []
        for x in fg["tensors"]:
            code, out = _http(f"{url}/request", "POST", {
                "model_id": mid, "inputs": [encode_tensor(x)],
                "sync": False})
            check(code == 200, f"frontend: HTTP async: {code} {out}")
            jobs.append(out["job_id"])
        for i, jid in enumerate(jobs):
            code, out = _http(f"{url}/wait", "POST", {"job_id": jid})
            check(code == 200 and np.array_equal(
                decode_tensor(out["outputs"][0]), fg["outputs"][i]),
                f"frontend: HTTP async + wait request {i}")
        _served(send, card, card_ref, "HTTP card-processed")
        rate = _rate(send, fg["tensors"][0])
        # hot swap: unregister, register again, still right
        code, out = _http(f"{url}/models/{mid}", "DELETE")
        check(code == 200 and out["unregistered"] == mid,
              f"frontend: HTTP unregister: {code} {out}")
        code, out = _http(f"{url}/request", "POST", {
            "model_id": mid, "inputs": [encode_tensor(fg["tensors"][0])]})
        check(code == 400, f"frontend: a request after unregister: {code}")
        code, reg = _http(f"{url}/models", "POST", {"path": FRONTEND_PATH})
        check(code == 200 and reg["model_id"] != mid,
              f"frontend: HTTP register again: {code} {reg}")
        mid = reg["model_id"]
        _served(send, fg["tensors"][:2], fg["outputs"], "HTTP hot-swapped")
        _, models = _http(f"{url}/models")
        _, stats = _http(f"{url}/stats")
        check(list(models) == [str(mid)]
              and list(stats["expected_latency_us"]) == [str(mid)]
              and stats["execution_counts"][str(mid)] >= 2,
              f"frontend: after the hot swap /models {list(models)}, "
              f"/stats {stats}")
    finally:
        httpd.shutdown()
        es.shutdown()
    log(f"frontend: HTTP: {len(fg['tensors'])} sync and "
        f"{len(fg['tensors'])} async + /wait golden outputs byte-equal to "
        f"TFLite, {len(card)} card-processed equal to the engine's; hot "
        f"swap served right; b1 {rate:.2f} req/s ({smi})")
    return rate


def frontend_router(bt, fg, card, card_ref, smi):
    """Two EngineServers (each its own engine and GPU worker on card 0)
    behind the router, under round_robin and least_loaded: golden and
    card-processed tensors, each backend's own /stats showing it served,
    and the b1 rate under each policy."""
    from band_tpu_torch.tools.router import serve_router
    from band_tpu_torch.tools.server import decode_tensor, encode_tensor, serve

    started = []
    rates = {}
    try:
        for _ in range(2):
            es, httpd = serve(_frontend_config(bt), port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            started.append((es, httpd))
        urls = [f"http://127.0.0.1:{h.server_address[1]}"
                for _, h in started]
        router, rhttpd = serve_router(urls, port=0, policy="round_robin")
        threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
        started.append((None, rhttpd))
        rurl = f"http://127.0.0.1:{rhttpd.server_address[1]}"
        code, reg = _http(f"{rurl}/models", "POST", {"path": FRONTEND_PATH})
        check(code == 200 and reg["replicas"] == 2,
              f"frontend: router register: {code} {reg}")
        name = reg["model"]

        def send(x):
            code, out = _http(f"{rurl}/request", "POST", {
                "model": name, "inputs": [encode_tensor(x)]})
            check(code == 200, f"frontend: router request: {code} {out}")
            return decode_tensor(out["outputs"][0])

        def served():
            return [sum(_http(f"{u}/stats")[1]["execution_counts"].values())
                    for u in urls]

        for policy in ("round_robin", "least_loaded"):
            router.policy = policy
            before = served()
            _served(send, fg["tensors"], fg["outputs"],
                    f"router {policy} golden")
            _served(send, card, card_ref, f"router {policy} card-processed")
            after = served()
            check(all(a > b for a, b in zip(after, before)),
                  f"frontend: router {policy}: a backend took no request "
                  f"({before} -> {after})")
            rates[policy] = _rate(send, fg["tensors"][0])
            log(f"frontend: router {policy}: {len(fg['tensors'])} golden "
                f"outputs byte-equal to TFLite, {len(card)} card-processed "
                f"equal to the engine's; backends served "
                f"{[a - b for a, b in zip(after, before)]}; b1 "
                f"{rates[policy]:.2f} req/s ({smi})")
    finally:
        for es, httpd in reversed(started):
            httpd.shutdown()
            if es is not None:
                es.shutdown()
    return rates


def frontend_c_abi(fg, frames, card, card_ref, smi):
    """The C ABI, driven as subprocesses on a GPU-worker config: main.c
    serves the golden and the card-processed tensors through
    BandEngineRequestSync (then times it), buffer_main.c turns the raw
    frames of each format into tensors through BandImageProcessorProcess
    and serves them (then times frame -> answer).  Their kernels launch
    in their own processes."""
    from band_tpu_torch.buffer.synthetic import frame_bytes
    from band_tpu_torch.c import build as cbuild

    work = os.path.join(ROOT, "band_tpu_torch", "_build", "frontend")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    exes = {n: cbuild.build_example(n, work) for n in ("main", "buffer_main")}
    build_s = time.perf_counter() - t0
    cfg = os.path.join(work, "gpu.json")
    with open(cfg, "w") as f:
        json.dump({"schedulers": ["fixed_worker"],
                   "workers": [{"device": "gpu", "device_ids": [0],
                                "max_batch": MAX_BATCH}]}, f)
    env = dict(os.environ, PYTHONPATH=cbuild.python_path())

    def run(*args):
        p = subprocess.run([str(a) for a in args], env=env,
                           capture_output=True, text=True, timeout=600)
        check(p.returncode == 0, f"frontend: C ABI {os.path.basename(args[0])}"
              f" exited {p.returncode}: {p.stderr[-2000:]} {p.stdout[-2000:]}")
        return p.stdout

    def number(out, key):
        line = next(l for l in out.split() if l.startswith(key + "="))
        return float(line.split("=")[1])

    n = len(fg["tensors"])
    inputs = os.path.join(work, "requests.bin")
    np.concatenate([fg["tensors"], np.stack(card)]).tofile(inputs)
    out = run(exes["main"], FRONTEND_PATH, cfg, inputs,
              os.path.join(work, "main_out"), FRONTEND_TIMED)
    # band_c.h BandDeviceFlag kBandGpu (1): the worker is the card's
    check("worker0_device=1" in out and "async_equals_sync=1" in out
          and "default_engine=1 default_workers=2" in out
          and "C API OK" in out, f"frontend: C ABI main.c: {out}")
    got = np.fromfile(os.path.join(work, "main_out.0"), np.int8).reshape(
        (2 * n,) + fg["outputs"].shape[1:])
    _served(lambda x: x, got[:n], fg["outputs"],
            "C ABI BandEngineRequestSync golden")
    _served(lambda x: x, got[n:], card_ref,
            "C ABI BandEngineRequestSync card-processed")
    c_rate = 1e3 / number(out, "c_api_ms_per_request")
    frame_ms = {}
    for fmt, code in (("rgb", 1), ("nv12", 6)):
        idx = [i for i, (f, _) in enumerate(frames) if f == fmt]
        raw = os.path.join(work, f"frames_{fmt}.bin")
        with open(raw, "wb") as f:
            for i in idx:
                f.write(frame_bytes(frames[i][1]))
        out = run(exes["buffer_main"], FRONTEND_PATH, cfg, raw, FRAME_W,
                  FRAME_H, code, os.path.join(work, f"tensors_{fmt}.bin"),
                  os.path.join(work, f"buffer_out_{fmt}"),
                  FRONTEND_TIMED // 2)
        check("BUFFER API OK" in out and out.count("ok=1") >= 6
              and "ok=0" not in out, f"frontend: C ABI buffer_main.c: {out}")
        ts = np.fromfile(os.path.join(work, f"tensors_{fmt}.bin"),
                         np.int8).reshape((len(idx),) + card[0].shape)
        _served(lambda x: x, ts, [card[i] for i in idx],
                f"C ABI BandImageProcessorProcess {fmt} tensor")
        outs = np.fromfile(os.path.join(work, f"buffer_out_{fmt}.0"),
                           np.int8).reshape((len(idx),)
                                            + fg["outputs"].shape[1:])
        _served(lambda x: x, outs, [card_ref[i] for i in idx],
                f"C ABI buffer_main {fmt} output")
        frame_ms[fmt] = number(out, "c_buffer_ms_per_request")
    log(f"frontend: C ABI (libband_tpu_torch_c.so and the examples built in "
        f"{build_s:.1f} s): main.c {n} golden outputs byte-equal to TFLite "
        f"and {n} card-processed equal to the engine's, b1 {c_rate:.2f} "
        f"req/s; buffer_main.c frames -> tensors equal to the Python "
        f"pipeline's, outputs equal to the engine's; frame -> answer ms "
        f"{json.dumps(frame_ms)} ({smi})")
    return c_rate, frame_ms


def frontend_calls(torch, dev, graphs, card, worst):
    """Gate 5: every kernel call of one b1 request of a card-processed
    frame, byte-equal to its plain version (not counted as launches of
    the phase)."""
    from band_tpu_torch.backend.program import build_program, params_from_jax
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L

    plain = {"qmatmul_exact": K.qmatmul_plain,
             "qconv2d_exact": K.qconv2d_plain,
             "qdwconv2d_exact": K.qdwconv2d_plain,
             "lut_softmax": K.lut_softmax_plain}
    g = graphs[FULL_WIDTH]
    with torch.inference_mode():
        prog = build_program(g, range(len(g.ops)), exact=True)
        params = params_from_jax(prog.params, dev)
        # a copy: to_tensor's batch axis is a numpy view with stride 0
        calls = capture_calls(L, prog.make_fn(), params,
                              [torch.from_numpy(card[0].copy()).to(dev)])
        torch.cuda.synchronize()
        for name, args, kw, out in calls:
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            held(torch, worst, name, args, kw, out, want,
                 f"frontend frame 0 {tuple(args[0].shape)}")
    kinds = collections.Counter(n for n, *_ in calls)
    check(set(kinds) == set(FRONTEND_RAN),
          f"frontend: a frame request's kernels {dict(kinds)}")
    check(b2_plan(*next(c[1:] for c in calls if c[0] == "qconv2d_exact")
                  ).branch == "direct",
          "frontend: the stem did not take B2's direct branch")
    log(f"frontend: every kernel call of a b1 frame request byte-equal to "
        f"plain (tolerance 0): {dict(kinds)}")


def frontend_phase(torch, dev, bt, K, graphs, worst, smi):
    """Camera frames to answers through every front end, on one GPU
    worker.  Returns (launch counts of the phase, summary)."""
    fg = load_frontend_goldens()
    frames = frontend_frames(fg)
    card, host_ms = frontend_dataplane(fg, frames, smi)
    K.reset_launches()
    eng = bt.Engine.create(_frontend_config(bt))
    try:
        t0 = time.perf_counter()
        mid = eng.register_model(bt.Model.from_path(FRONTEND_PATH))
        check(eng.wait_buckets_ready(timeout=600),
              "frontend: bucket warm-up timed out")
        log(f"frontend: {FULL_WIDTH} registered, buckets warm in "
            f"{time.perf_counter() - t0:.2f} s")

        def send(x):
            return eng.request_sync(mid, [x])[0]

        _served(send, fg["tensors"], fg["outputs"], "engine sync golden")
        ids = [eng.request_async(mid, [x]) for x in fg["tensors"]]
        _served(lambda j: eng.wait(j)[0], ids, fg["outputs"],
                "engine burst golden")
        card_ref = [send(x) for x in card]
        engine_rate = _rate(send, fg["tensors"][0])
        # frame -> answer in this process: the host pipeline, then the
        # engine, back to back
        from band_tpu_torch.buffer.processor import ImageProcessorBuilder

        proc = ImageProcessorBuilder().add_auto_convert(
            card[0].shape, np.int8).build()
        frame_ms = {}
        for fmt in ("rgb", "nv12"):
            buf = next(b for f, b in frames if f == fmt)
            t0 = time.perf_counter()
            for _ in range(FRONTEND_TIMED // 2):
                send(proc.to_tensor(buf))
            frame_ms[fmt] = 1e3 * (time.perf_counter() - t0) / (
                FRONTEND_TIMED // 2)
    finally:
        eng.shutdown()
    log(f"frontend: engine: {len(fg['tensors'])} sync and a burst of "
        f"{len(ids)} golden outputs byte-equal to TFLite; b1 "
        f"{engine_rate:.2f} req/s; frame -> answer ms {json.dumps(frame_ms)}"
        f" ({smi})")
    http_rate = frontend_http(bt, fg, card, card_ref, smi)
    router_rates = frontend_router(bt, fg, card, card_ref, smi)
    counts = K.launch_counts()
    for name in K.LAUNCHES:
        check((counts[name] > 0) == (name in FRONTEND_RAN + (ADDSUB,)),
              f"frontend: kernel {name} launched {counts[name]} times")
    log(f"frontend: launches {json.dumps(counts)}")
    c_rate, c_frame_ms = frontend_c_abi(fg, frames, card, card_ref, smi)
    frontend_calls(torch, dev, graphs, card, worst)
    b1 = {"engine": engine_rate, "http": http_rate,
          "router_round_robin": router_rates["round_robin"],
          "router_least_loaded": router_rates["least_loaded"],
          "c_abi": c_rate}
    ms = {k: 1e3 / v for k, v in b1.items()}
    summary = {
        "card": smi, "model": FULL_WIDTH, "b1_req_s": b1,
        "ms_per_request_over_engine": {
            k: v - ms["engine"] for k, v in ms.items() if k != "engine"},
        "host_ms_per_frame": host_ms,
        "frame_to_answer_ms": {"engine": frame_ms, "c_abi": c_frame_ms},
        "preprocess_share": {
            fmt: host_ms[fmt] / frame_ms[fmt] for fmt in frame_ms},
    }
    return counts, summary


# --------------------------------------------------------------------------
# mesh: one engine over two processes on the card (parallel/)
# --------------------------------------------------------------------------

MESH_TIMEOUT_S = 480
MESH_SYNC = 16          # timed request_sync a worker (the goldens twice)
MESH_RAN = ("qmatmul_exact", "qconv2d_exact", "qdwconv2d_exact",
            "lut_softmax")
# (name, worker spec) of the mesh phase's engine, worker ids in order
MESH_WORKERS = (
    ("tp2", {"device": "gpu", "device_ids": [0, 1], "mesh_shape": [1, 2],
             "max_batch": MAX_BATCH}),
    ("dp2", {"device": "gpu", "device_ids": [0, 1], "mesh_shape": [2, 1],
             "max_batch": MAX_BATCH}),
    ("single", {"device": "gpu", "device_ids": [0], "max_batch": MAX_BATCH}),
)


def _free_port():
    """A free port p whose p + 1000, the SPMD control channel's default
    (parallel/spmd.py control_address), is a port and free too (an
    ephemeral port above 64535 has no such neighbour)."""
    import socket

    while True:
        socks = [socket.socket(), socket.socket()]
        try:
            socks[0].bind(("localhost", 0))
            port = socks[0].getsockname()[1]
            if port + 1000 > 65535:
                continue
            socks[1].bind(("localhost", port + 1000))
            return port
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


def _mesh_config(coord, rank, workers, **extra):
    """A runtime config of the mesh phase: two processes on card 0, each
    owning it as its local device 0 (global device ids 0 and 1)."""
    d = {"schedulers": ["fixed_worker"], "workers": workers,
         "profile_warmup_runs": 1, "profile_num_runs": 1,
         "distributed": {"coordinator_address": coord, "num_processes": 2,
                         "process_id": rank, "local_device_ids": [0],
                         "control_port": int(coord.rpartition(":")[2])
                         + extra.pop("control_offset", 1000)}}
    d.update(extra)
    return d


def _mesh_serve(bt, M, eng, mid, xs, want):
    """The leader's part: each worker serves the goldens sync (timed) and
    as one burst, every output byte-equal to TFLite's and to the single
    worker's.  Returns per-worker rates and collectives."""
    out, single = {}, None
    n = len(xs)
    order = [("single", 2), ("tp2", 0), ("dp2", 1)]
    for wname, wid in order:
        opt = bt.RequestOption(target_worker=wid)
        eng.request_sync(mid, [xs[0]], opt)  # this worker's first request
        before = M.collective_stats()
        t0 = time.perf_counter()
        got = [eng.request_sync(mid, [xs[i % n]], opt)[0]
               for i in range(MESH_SYNC)]
        dt = time.perf_counter() - t0
        stats = {k: v - before[k] for k, v in M.collective_stats().items()}
        if single is None:
            single = got[:n]
        for i, o in enumerate(got):
            check(np.array_equal(o, want[i % n]),
                  f"mesh {wname}: sync request {i} differs from TFLite")
            check(np.array_equal(o, single[i % n]),
                  f"mesh {wname}: sync request {i} differs from the single "
                  "worker's")
        ids = eng.request_async_batch([mid] * n, [[x] for x in xs],
                                      [opt] * n)
        st = eng.wait_all(ids, timeout=120, raise_on_incomplete=True)
        check(all(v == bt.JobStatus.SUCCESS for v in st.values()),
              f"mesh {wname}: burst {st}")
        for i, jid in enumerate(ids):
            o = eng.get_outputs(jid)[0]
            check(np.array_equal(o, want[i]) and np.array_equal(o, single[i]),
                  f"mesh {wname}: burst request {i} differs")
        ex = eng.model_record(mid).executors[wid]
        out[wname] = {
            "b1_req_s": MESH_SYNC / dt, "ms_per_request": 1e3 * dt / MESH_SYNC,
            "gathers_per_request": stats["gathers"] / MESH_SYNC,
            "gather_host_ms_per_request":
                1e3 * stats["gather_host_s"] / MESH_SYNC,
            "broadcasts_per_request": stats["broadcasts"] / MESH_SYNC,
            "windows": {str(k): v for k, v in sorted(ex.windows.items())},
        }
    return out


def _mesh_calls(torch, K, L, M, g, xs, want, rank):
    """Every kernel call of one golden request through a tp=2 mesh over
    both processes (each runs its half of every split op), held
    byte-equal to the kernel's plain version in this process."""
    from band_tpu_torch.backend.program import build_program

    plain = {"qmatmul_exact": K.qmatmul_plain,
             "qconv2d_exact": K.qconv2d_plain,
             "qdwconv2d_exact": K.qdwconv2d_plain,
             "lut_softmax": K.lut_softmax_plain}
    dev = torch.device("cuda", 0)
    mesh = M.Mesh([dev, dev], 1, 2, [0, 1])
    prog = build_program(g, range(len(g.ops)), exact=True, device=dev)
    sp = M.ShardedProgram(prog, mesh)
    with torch.inference_mode():
        calls = capture_calls(L, sp.run, sp.params,
                              [torch.from_numpy(xs[0]).to(dev)])
        torch.cuda.synchronize()
        worst = collections.Counter()
        widths = collections.defaultdict(set)
        for name, args, kw, out in calls:
            want_k = plain[name](*args, **kw)
            torch.cuda.synchronize()
            worst[name] = max(worst[name], same(
                torch, name, out, want_k, f"mesh p{rank} {tuple(out.shape)}"))
            widths[name].add(int(out.shape[-1]))
    # the last call is the softmax, run whole after the FC's gather
    check(np.array_equal(calls[-1][3].cpu().numpy(), want[0]),
          f"mesh p{rank}: the sharded request differs from TFLite")
    kinds = collections.Counter(n for n, *_ in calls)
    check(set(kinds) == set(MESH_RAN), f"mesh p{rank}: kernels {kinds}")
    check(b2_plan(*next(c[1:] for c in calls if c[0] == "qconv2d_exact")
                  ).branch == "direct",
          f"mesh p{rank}: the half-width stem left B2's direct branch")
    return {"calls": dict(kinds), "max_abs_err": dict(worst),
            "widths": {k: [min(v), max(v)] for k, v in widths.items()}}


def mesh_child(rank, coord):
    """One of the mesh phase's two processes: an engine with the tp=2,
    dp=2 and single workers over both processes (process 0 drives it,
    process 1 replays), then one request's kernel calls held against
    plain, then the benchmark tool's distributed branch.  Prints one
    MESH_RESULT line."""
    import torch

    sys.path.insert(0, ROOT)
    import band_tpu_torch as bt
    from band_tpu_torch.config import config_from_dict
    from band_tpu_torch.ops import kernels as K
    from band_tpu_torch.ops import lowerings as L
    from band_tpu_torch.parallel import mesh as M
    from band_tpu_torch.parallel.spmd import SpmdChannel
    from band_tpu_torch.tflite.parser import parse_tflite_file
    from band_tpu_torch.tools.benchmark import BenchmarkConfig, run_distributed

    if not torch.cuda.is_available():
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(DATA, f"{FULL_WIDTH}.tflite")
    g = parse_tflite_file(path)
    z = np.load(GOLDENS)
    want = z[f"{FULL_WIDTH}/output"]
    xs = _inputs(z, FULL_WIDTH, g, len(want))
    res = {"rank": rank}
    eng = bt.Engine.create(config_from_dict(_mesh_config(
        coord, rank, [w for _, w in MESH_WORKERS])))
    try:
        t0 = time.perf_counter()
        mid = eng.register_model(bt.Model.from_path(path))
        res["register_s"] = time.perf_counter() - t0
        channel = SpmdChannel(eng, coordinator_address=coord,
                              control_port=int(coord.rpartition(":")[2])
                              + 1000)
        channel.barrier()
        # the main path: counts zeroed just before, read just after
        K.reset_launches()
        M.reset_collective_stats()
        if rank == 0:
            channel.attach()
            try:
                res["workers"] = _mesh_serve(bt, M, eng, mid, xs, want)
            finally:
                channel.shutdown_followers()
        else:
            channel.run_follower()
        res["launches"] = K.launch_counts()
        res["collectives"] = M.collective_stats()
    finally:
        eng.shutdown()
    for name, n in res["launches"].items():
        check((n > 0) == (name in MESH_RAN + (ADDSUB,)),
              f"mesh p{rank}: kernel {name} launched {n} times")
    res["held"] = _mesh_calls(torch, K, L, M, g, xs, want, rank)
    res["benchmark"] = run_distributed(BenchmarkConfig.from_dict(_mesh_config(
        coord, rank, [MESH_WORKERS[0][1]], control_offset=2000,
        models=[{"graph": path, "period_ms": 5, "batch_size": 2}],
        running_time_ms=BENCH_MS, execution_mode="periodic")))
    print("MESH_RESULT" + json.dumps(res), flush=True)
    return 0


def mesh_single_process(torch, bt, goldens, smi):
    """A tp=2 mesh in one process: over cuda:0,1 where two cards are
    visible, served byte-equal to the goldens; else the engine must refuse
    device ids (0, 1) with ConfigError (never wrap onto one card)."""
    n_cards = torch.cuda.device_count()
    cfg = (bt.RuntimeConfigBuilder()
           .add_scheduler(bt.SchedulerType.FIXED_WORKER)
           .add_worker(bt.WorkerSpec(device=bt.DeviceFlag.GPU,
                                     device_ids=(0, 1), mesh_shape=(1, 2),
                                     max_batch=MAX_BATCH))
           .build())
    if n_cards < 2:
        try:
            bt.Engine.create(cfg)
        except bt.ConfigError as e:
            log(f"mesh: single-process tp=2 over cuda:0,1 refused on "
                f"{n_cards} card: ConfigError: {e}")
            return {"cards": n_cards, "refused": str(e)}
        raise AssertionError("a mesh over two cards was served on one")
    eng = bt.Engine.create(cfg)
    try:
        mid = eng.register_model(bt.Model.from_path(
            os.path.join(DATA, f"{FULL_WIDTH}.tflite")))
        xs, want = goldens[FULL_WIDTH]["xs"], goldens[FULL_WIDTH]["output"][0]
        t0 = time.perf_counter()
        for i, x in enumerate(xs):
            check(np.array_equal(eng.request_sync(mid, [x])[0], want[i]),
                  f"mesh: single-process tp=2 request {i} differs")
        rate = len(xs) / (time.perf_counter() - t0)
    finally:
        eng.shutdown()
    log(f"mesh: single-process tp=2 over cuda:0,1: {len(xs)} requests "
        f"byte-equal to TFLite, {rate:.2f} req/s ({smi})")
    return {"cards": n_cards, "b1_req_s": rate}


def mesh_phase(torch, bt, goldens, smi):
    """Two processes on cuda:0 (the kernels already built here), one
    engine over both; then the single-process mesh.  Returns (launches of
    the served phase summed over both processes, summary)."""
    coord = f"localhost:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", str(r),
         coord], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    results = {}
    try:
        for r, p in enumerate(procs):
            left = max(MESH_TIMEOUT_S - (time.perf_counter() - t0), 1)
            out, err = p.communicate(timeout=left)
            check(p.returncode == 0, f"mesh: process {r} exited "
                  f"{p.returncode}:\n{err[-8000:]}\n{out[-2000:]}")
            line = next((ln for ln in out.splitlines()
                         if ln.startswith("MESH_RESULT")), None)
            check(line is not None, f"mesh: process {r} printed no result")
            results[r] = json.loads(line[len("MESH_RESULT"):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    drv = results[0]
    for wname, w in drv["workers"].items():
        log(f"mesh: {wname} b1 {w['b1_req_s']:.2f} req/s, "
            f"{w['ms_per_request']:.2f} ms a request; gathers a request "
            f"{w['gathers_per_request']:.1f}, their host ms "
            f"{w['gather_host_ms_per_request']:.3f}; broadcasts a request "
            f"{w['broadcasts_per_request']:.2f}; windows {w['windows']} "
            f"({smi})")
    for r in (0, 1):
        log(f"mesh: process {r} launches {json.dumps(results[r]['launches'])}"
            f"; collectives {json.dumps(results[r]['collectives'])}; "
            f"registered in {results[r]['register_s']:.2f} s")
        h = results[r]["held"]
        log(f"mesh_calls: process {r}: a tp=2 request's kernel calls "
            f"{json.dumps(h['calls'])} byte-equal to plain (max |err| "
            f"{json.dumps(h['max_abs_err'])}); output widths "
            f"{json.dumps(h['widths'])}")
    bench = drv["benchmark"]
    check(bench is not None and results[1]["benchmark"] is None,
          "mesh: the distributed benchmark reports from process 0 only")
    check(bench["total"]["processed"] > 0 and bench["total"]["canceled"] == 0,
          f"mesh: distributed benchmark {bench['total']}")
    log(f"benchmark: mesh_tp2 (2 processes) {json.dumps(bench)} ({smi})")
    single = mesh_single_process(torch, bt, goldens, smi)
    counts = {name: results[0]["launches"][name] + results[1]["launches"][name]
              for name in results[0]["launches"]}
    summary = {"card": smi, "model": FULL_WIDTH, "wall_s": wall,
               "workers": drv["workers"],
               "launches": {r: results[r]["launches"] for r in (0, 1)},
               "benchmark_req_s": bench["model_0"]["fps"],
               "single_process": single}
    return counts, summary


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
              + (SR_MODEL,) + FLOAT_MODELS + SRFLOAT_MODELS
              + (DETECT_MODEL, SEQ_INT8)}
    seq_files = seq_paths()
    graphs.update({n: parse_tflite_file(p) for n, p in seq_files.items()})
    goldens = load_goldens(graphs)
    fast_goldens = load_fast_goldens(graphs)
    hetero_goldens = load_hetero_goldens()

    ops_goldens = load_ops_goldens(graphs)
    float_goldens = load_float_goldens(graphs)
    srfloat_goldens = load_srfloat_goldens()
    detect_goldens = load_detect_goldens(graphs)
    seq_goldens = load_seq_goldens(graphs)
    seq_goldens["paths"] = seq_files
    worst, stats, sr_calls, detect_b1 = kernel_phase(
        torch, dev, graphs, goldens, hetero_goldens, ops_goldens,
        detect_goldens, seq_goldens)
    hybrid_stats = hybrid_kernel_lines(torch, dev, graphs, float_goldens,
                                       smi)
    hybrid_conv_stats = hybrid_conv_lines(torch, dev, graphs,
                                          srfloat_goldens, smi)
    conv_softmax_lines(torch, dev, graphs, goldens, fast_goldens,
                       sm_mhz / 1e3)
    addsub_stats = addsub_phase(torch, dev, graphs, goldens, smi)
    counts, rates = engine_phase(torch, bt, K, MODELS, goldens, card,
                                 bt.DeviceFlag.GPU, "exact")
    fast_counts, fast_rates = engine_phase(torch, bt, K, FAST_MODELS,
                                           fast_goldens, card,
                                           bt.DeviceFlag.GPU, "fast")
    mixed_phase(bt, K, goldens, fast_goldens, bt.DeviceFlag.GPU)
    sr_counts, sr_rates, mma_stats = sr_phase(torch, dev, bt, K, graphs,
                                              ops_goldens, sr_calls, smi)
    float_counts, float_rates, float_worst = float_phase(
        torch, dev, bt, K, graphs, float_goldens, smi)
    (srfloat_counts, srfloat_rates, srfloat_worst,
     srfloat_profiles) = srfloat_phase(torch, dev, bt, K, graphs,
                                       srfloat_goldens, smi)
    detect_counts, detect_rates, detect_profiles = detect_phase(
        torch, dev, bt, K, graphs, detect_goldens, smi)
    seq_counts, seq_rates, seq_profiles, seq_worst, seq_unfused = seq_phase(
        torch, dev, bt, K, graphs, seq_goldens, smi)
    smallest = detect_kernel_lines(torch, detect_b1, smi)
    decode = detect_decode_lines(torch, dev, graphs, detect_goldens, smi,
                                 smallest)
    depth_phase(torch, dev, graphs, goldens, fast_goldens)
    profile_phase(torch, dev, graphs, goldens, exact=True, xprof=smi)
    profile_phase(torch, dev, graphs, goldens, exact=False)
    hetero_phase(torch, bt, K, goldens, hetero_goldens, smi)
    co_counts, _ = codispatch_phase(torch, bt, K, goldens, smi)
    monitor_phase(torch, bt, goldens, smi)
    benchmark_phase(smi)
    fe_counts, fe_summary = frontend_phase(torch, dev, bt, K, graphs, worst,
                                           smi)
    mesh_counts, mesh_summary = mesh_phase(torch, bt, goldens, smi)

    log("engine: " + json.dumps({"card": smi, "numerics": "exact",
                                 "models": rates}))
    log("fast: " + json.dumps({"card": smi, "numerics": "fast",
                               "models": fast_rates}))
    log("sr: " + json.dumps({"card": smi, "model": SR_MODEL,
                             "numerics": sr_rates}))
    log("float: " + json.dumps({"card": smi, "models": float_rates,
                                "worst_deviation": float_worst}))
    log("srfloat: " + json.dumps({"card": smi, "models": srfloat_rates,
                                  "worst_deviation": srfloat_worst,
                                  "b1_request": srfloat_profiles}))
    log("detect: " + json.dumps({"card": smi, "model": DETECT_MODEL,
                                 "numerics": detect_rates,
                                 "b1_request": detect_profiles,
                                 "decode": decode}))
    log("seq: " + json.dumps({"card": smi, "models": seq_rates,
                              "worst_of_bound": seq_worst,
                              "b1_request": seq_profiles,
                              "codispatch_unfused_windows": seq_unfused}))
    log("frontend: " + json.dumps(fe_summary))
    log("mesh: " + json.dumps(mesh_summary))
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
            # the detect phase's CenterNet requests, exact and fast
            "detect_launches": detect_counts[name],
            # the seq phase's requests (lstm_seq_int8's head and softmax)
            "seq_launches": seq_counts[name],
            # the frontend phase's requests (engine, HTTP, router)
            "frontend_launches": fe_counts[name],
            # the mesh phase's, both processes
            "mesh_launches": mesh_counts[name],
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
            "detect_launches": detect_counts[name],
            "seq_launches": seq_counts[name],
            "frontend_launches": fe_counts[name],
            "mesh_launches": mesh_counts[name],
        })
    for name, meta in HYBRID_KERNELS.items():
        s = hybrid_stats
        # the hybrid GEMM: its launches on its main path, the float phase;
        # the times of a b1 dynamic-range MobileNetV2 request's calls
        line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": float_counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_s"] >= s["ops_s"] else "operations",
            "library_ms": s["library_ms"], "library": s["library"],
            "mobilenet_v2_dynrange_b1_launches": s["launches_b1"],
            "seq_launches": seq_counts[name],
            "frontend_launches": fe_counts[name],
            "mesh_launches": mesh_counts[name],
        })
    for name, meta in HYBRID_CONV_KERNELS.items():
        s = hybrid_conv_stats
        # the hybrid conv: its launches on its main path, the srfloat
        # phase; the time of a b1 dynamic-range FSRCNN request's call
        line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": srfloat_counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_s"] >= s["ops_s"] else "operations",
            "library_ms": s["library_ms"],
            "fsrcnn_dynrange_b1_launches": s["launches_b1"],
            "codispatch_launches": co_counts[name],
            "sr_launches": sr_counts[name],
            "detect_launches": detect_counts[name],
            "seq_launches": seq_counts[name],
            "frontend_launches": fe_counts[name],
            "mesh_launches": mesh_counts[name],
        })
    s = addsub_stats
    # the exact ADD/SUB: its launches in the exact engine phase; a b1
    # MobileNetV2 request's ten calls (addsub_phase)
    line.append({
        "name": ADDSUB, "route": "cuda",
        "source": "band_tpu_torch/ops/kernels/csrc/qaddsub.cu",
        "replaces": "band_tpu/ops/lowerings.py ADD/SUB (XLA int64 ops)",
        "launches": counts[ADDSUB], "max_abs_err": s["max_abs_err"],
        "ms": s["ms"], "plain_ms": s["plain_ms"], "chain_ms": s["chain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "mobilenet_v2_b1_launches": s["launches_b1"],
        "codispatch_launches": co_counts[ADDSUB],
        "sr_launches": sr_counts[ADDSUB],
        "detect_launches": detect_counts[ADDSUB],
        "seq_launches": seq_counts[ADDSUB],
        "frontend_launches": fe_counts[ADDSUB],
        "mesh_launches": mesh_counts[ADDSUB],
    })
    log(json.dumps({"kernels": line}))
    log(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-child":
        sys.exit(mesh_child(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
