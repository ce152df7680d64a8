"""Time the int8 GEMM kernels (B1, B4) under every block tile and K
split, at the GEMM shapes of a MobileNetV2 1.0/224 request, on one card.

    python -m band_tpu_torch.ops.kernels.sweep_gemm [--batch 1] [--out F]

Each (shape, tile, splits) is timed as chip_smoke.py times a kernel: a
CUDA graph of 20 launches, replayed, CUDA events.  Prints one JSON line
per shape: gemm_plan's choice and its time, and the fastest plan found
for each numerics; with --out, every timing as JSON.  Needs a CUDA card;
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import qmatmul as QM

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DATA = os.path.join(ROOT, "tests", "data")


def capture_calls(model, batch, lowering, key, stand_in=None):
    """key(*args, **kwargs) -> calls, over every call that one run of
    ``model`` (a tests/data model; without its custom ops, which run on a
    host worker) at ``batch`` makes to the kernel that ops/lowerings.py
    binds as ``lowering``, from the port's program run on the CPU;
    ``stand_in``, if given, runs in the kernel's place."""
    from ...backend.program import build_program, params_from_jax
    from ...tflite.parser import parse_tflite_file
    from .. import lowerings as L

    g = parse_tflite_file(os.path.join(DATA, f"{model}.tflite"))
    # every op but a custom op (the SSD models' host-only post-process)
    prog = build_program(g, [op.index for op in g.ops if not op.is_custom],
                         exact=True)
    params = params_from_jax(prog.params, torch.device("cpu"))
    calls = {}
    kernel = getattr(L, lowering)

    def capture(*args, **kw):
        k = key(*args, **kw)
        calls[k] = calls.get(k, 0) + 1
        return (stand_in or kernel)(*args, **kw)

    shape = g.tensor(g.inputs[0]).shape[1:]
    setattr(L, lowering, capture)
    try:
        with torch.inference_mode():
            prog.make_fn()(params, [torch.zeros((batch, *shape),
                                                dtype=torch.int8)])
    finally:
        setattr(L, lowering, kernel)
    return calls


def mobilenet_v2_gemms(batch):
    """(M, N, K) -> calls of every int8 GEMM of one MobileNetV2 run at
    ``batch``, from the port's program run on the CPU."""
    return capture_calls("mobilenet_v2_int8", batch, "qmatmul_exact",
                         lambda a, b, *_, **__: (a.shape[0], b.shape[1],
                                                 a.shape[1]))


def graph_ms(fn, launches=20, replays=10):
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


def plans(M, N, K):
    """Every (tile, splits) the kernel takes for this shape, as plans."""
    ksteps = -(-K // QM.KSTEP)
    seen = set()
    for tile, (warps, mi, _) in enumerate(QM.TILES):
        bm, bn = 16 * mi * warps, QM.BN
        for splits in range(1, min(QM.MAX_SPLITS, max(ksteps, 1)) + 1):
            kt_per = -(-ksteps // splits)
            s = -(-ksteps // kt_per) if kt_per else 1
            if (tile, s) in seen:
                continue
            seen.add((tile, s))
            yield QM.GemmPlan(tile, bm, bn, s, kt_per,
                              (-(-M // bm), -(-N // bn), s))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_gemm: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    planner = QM.gemm_plan
    rows = []
    try:
        for (M, N, K), calls in sorted(mobilenet_v2_gemms(args.batch).items(),
                                       key=lambda kv: -kv[0][0]):
            a = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int8)).to(dev)
            b = torch.from_numpy(rng.integers(-128, 128, (K, N), dtype=np.int8)).to(dev)
            bias = torch.zeros(N, dtype=torch.int32, device=dev)
            qm = torch.full((N,), 1 << 30, dtype=torch.int32, device=dev)
            shift = torch.full((N,), -12, dtype=torch.int32, device=dev)
            mult = torch.full((N,), 2.0 ** -13, dtype=torch.float32, device=dev)
            want = (QM.qmatmul_plain(a, b, bias, qm, shift),
                    QM.qmatmul_fast_plain(a, b, bias, mult))
            run = {"exact": lambda: QM.qmatmul_exact(a, b, bias, qm, shift),
                   "fast": lambda: QM.qmatmul_fast(a, b, bias, mult)}
            timings = []
            for p in plans(M, N, K):
                QM.gemm_plan = lambda m, n, k, p=p: p
                got = (run["exact"](), run["fast"]())
                assert all(torch.equal(g, w) for g, w in zip(got, want)), p
                timings.append(dict(tile=f"{p.bm}x{p.bn}", tile_index=p.tile,
                                    splits=p.splits, blocks=p.blocks,
                                    **{k: graph_ms(f) for k, f in run.items()}))
            QM.gemm_plan = planner
            chosen = planner(M, N, K)
            mine = next(t for t in timings if t["tile_index"] == chosen.tile
                        and t["splits"] == chosen.splits)
            best = {k: min(timings, key=lambda t: t[k]) for k in run}
            row = dict(M=M, N=N, K=K, calls=calls,
                       plan=f"{chosen.bm}x{chosen.bn}/{chosen.splits}",
                       plan_exact_ms=mine["exact"], plan_fast_ms=mine["fast"],
                       **{f"best_{k}": f"{t['tile']}/{t['splits']}"
                          for k, t in best.items()},
                       **{f"best_{k}_ms": t[k] for k, t in best.items()})
            print("sweep: " + json.dumps(row), flush=True)
            rows.append(dict(row, timings=timings))
    finally:
        QM.gemm_plan = planner
    total = {k: sum(r["calls"] * r[k] for r in rows)
             for k in ("plan_exact_ms", "plan_fast_ms", "best_exact_ms",
                       "best_fast_ms")}
    print("sweep total: " + json.dumps(total), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
