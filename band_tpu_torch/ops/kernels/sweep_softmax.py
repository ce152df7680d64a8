"""Time the quantized softmax kernel's two branches (a thread per row, a
block per row under each block size) over rows and depths that span the
slice models' SOFTMAX shapes, on one card.

    python -m band_tpu_torch.ops.kernels.sweep_softmax [--out F]

Each (shape, plan) is held byte-equal to the plain version and timed as
chip_smoke.py times a kernel: a CUDA graph of 20 launches, replayed,
CUDA events.  Prints one JSON line per shape: softmax_plan's choice and
its time, and the fastest plan; with --out, every timing as JSON.
Needs a CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import quant as Q
from . import softmax as SM
from .sweep_gemm import graph_ms

ROWS = (1, 8, 64, 512)
DEPTHS = (8, 10, 16, 32, 64, 128, 256, 1000, 4000)
ROW_THREADS = (32, 64, 128, 256)


def plans(rows, depth):
    yield SM.thread_plan(rows)
    if SM.row_smem(depth) <= SM.MAX_SMEM:
        for t in ROW_THREADS:
            yield SM.row_plan(rows, depth, t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_softmax: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(Q.softmax_table(0.0625, 1.0)).to(dev)
    planner = SM.softmax_plan
    rows_out = []
    try:
        for depth in DEPTHS:
            for rows in ROWS:
                x = torch.from_numpy(rng.integers(
                    -128, 128, (rows, depth), dtype=np.int8)).to(dev)
                want = SM.lut_softmax_plain(x, table, 1.0 / 256, -128,
                                            torch.int8)

                def run():
                    return SM.lut_softmax(x, table, 1.0 / 256, -128,
                                          torch.int8)

                chosen = planner(rows, depth)
                timings = []
                for p in plans(rows, depth):
                    SM.softmax_plan = lambda *a, p=p: p
                    assert torch.equal(run(), want), p
                    timings.append(dict(plan=p.name, ms=graph_ms(run)))
                SM.softmax_plan = planner
                mine = next(t for t in timings if t["plan"] == chosen.name)
                best = min(timings, key=lambda t: t["ms"])
                row = dict(rows=rows, depth=depth, plan=chosen.name,
                           plan_ms=mine["ms"], best=best["plan"],
                           best_ms=best["ms"], thread_ms=timings[0]["ms"])
                print("sweep: " + json.dumps(row), flush=True)
                rows_out.append(dict(row, timings=timings))
    finally:
        SM.softmax_plan = planner
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
