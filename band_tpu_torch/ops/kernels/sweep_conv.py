"""Time the int8 conv kernels (B2 and its fast instance) under every
direct variant and tile, every N tile and pixel tile of the mma branch,
and qgemm.cuh's loop, at the B2 shapes of the tests/data models (the
slice CNNs, FSRCNN x2 at 360x640 and the decoder models), on one card.

    python -m band_tpu_torch.ops.kernels.sweep_conv [--batch 1] [--out F]

Each (shape, plan) is held byte-equal to the plain version and timed as
chip_smoke.py times a kernel: a CUDA graph of 20 launches, replayed,
CUDA events.  Prints one JSON line per shape: conv_plan's choice and
its time, the fastest plan found for each numerics, the fastest of each
branch, and the loop's time; with --out, every timing as JSON.  Needs a
CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from . import qconv as QC
from .sweep_gemm import capture_calls, graph_ms

MODELS = ("mobilenet_v2_int8", "effnetlite_int8", "resnetish_int8",
          "fc_int8", "fsrcnn_x2_int8", "fsrcnn_x2_small_int8", "tconv_int8",
          "cnn_ops_int8", "attention_int8")
TILE_ROWS = (1, 2, 4, 8, 16)
TILE_COLS = (8, 16, 32)
MMA_TILE_COLS = (16, 32, 64, 128, 256)


def conv_shapes(batch, models=MODELS):
    """Geometry -> calls of every B2 conv of one run of each of ``models``
    at ``batch``.  A geometry is (n, h, w, ci, oc, kh, kw, stride,
    dilation, padding).  The calls are captured from the port's program
    run on the CPU at batch 1 with B2 replaced by an empty output of its
    shape (a stacked window makes the same calls with n = batch)."""
    shapes = {}
    for model in models:
        for geom, calls in _b1_shapes(model).items():
            key = (batch, *geom[1:])
            shapes[key] = shapes.get(key, 0) + calls
    return shapes


@functools.lru_cache(maxsize=None)
def _b1_shapes(model):
    def key(x, w, *_, **kw):
        return (*x.shape, w.shape[1], kw["kh"], kw["kw"],
                tuple(kw["stride"]), tuple(kw["dilation"]),
                tuple(tuple(p) for p in kw["padding"]))

    return capture_calls(model, 1, "qconv2d_exact", key, shape_only)


def shape_only(x, w_km, *_, kh, kw, stride=(1, 1), dilation=(1, 1),
               padding=((0, 0), (0, 0)), out_dtype=torch.int8, **__):
    """B2's output for these operands, zeros: what a capture runs in the
    kernel's place where only the calls' shapes matter."""
    n, h, wd, _ = x.shape
    oh = QC.conv_out_size(h, kh, stride[0], dilation[0], sum(padding[0]))
    ow = QC.conv_out_size(wd, kw, stride[1], dilation[1], sum(padding[1]))
    return torch.zeros((n, oh, ow, w_km.shape[1]), dtype=out_dtype)


def out_size(geom):
    """(oh, ow) of a geometry."""
    n, h, w, ci, oc, kh, kw, (sh, sw), (dh, dw), ((pt, pb), (pl, pr)) = geom
    return (QC.conv_out_size(h, kh, sh, dh, pt + pb),
            QC.conv_out_size(w, kw, sw, dw, pl + pr))


def plans(geom):
    """Every direct plan that fits this geometry (each variant on each
    tile), every mma plan (each N tile on each pixel tile, with the
    general branch's channel groups), then qgemm.cuh's loop."""
    n, h, w, ci, oc, kh, kw, stride, dil, _ = geom
    oh, ow = out_size(geom)
    for v in range(len(QC.DIRECT_VARIANTS)):
        for th in TILE_ROWS:
            for tw in TILE_COLS:
                p = QC.direct_plan(v, n, oh, ow, ci, oc, kh, kw, stride, dil,
                                   th, tw)
                if QC.fits(p, ci, oc):
                    yield p
    general = QC.general_plan(n, oh, ow, ci, oc, kh, kw, stride, dil)
    for v in range(len(QC.MMA_NTILES)):
        for pixels in QC.MMA_PIXELS:
            for tw in MMA_TILE_COLS:
                if tw > pixels or (tw > 16 and tw // 2 >= ow):
                    continue
                p = QC.mma_plan(v, n, oh, ow, oc, kh, kw, stride, dil,
                                pixels // tw, tw, general.slabs,
                                general.gather)
                if QC.mma_fits(p, ci, kh, kw):
                    yield p
    yield QC.loop_plan(n, oh, ow, oc)


def operands(geom, rng, dev):
    """x, w, (bias, qm, shift), mult of a geometry: random int8 data and
    multipliers that map the accumulator's spread to ~30 units."""
    from .. import quant as Q

    n, h, w, ci, oc, kh, kw, *_ = geom

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    m = 30.0 / (np.sqrt(kh * kw * ci) * 73.0 * 73.0) * rng.uniform(
        0.5, 2.0, oc)
    qm, sh = Q.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, oc).astype(np.int32)
    return (t(rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)),
            t(rng.integers(-128, 128, (kh * kw * ci, oc), dtype=np.int8)),
            (t(bias), t(qm), t(sh)), t(m.astype(np.float32)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_conv: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    planner = QC.conv_plan
    rows = []
    try:
        shapes = conv_shapes(args.batch)
        for geom, calls in sorted(shapes.items(),
                                  key=lambda kv: -np.prod(kv[0][:4])):
            n, h, w, ci, oc, kh, kw, stride, dil, pad = geom
            x, wk, epi, mult = operands(geom, rng, dev)
            conv = dict(kh=kh, kw=kw, stride=stride, dilation=dil,
                        padding=pad, x_zp=-3)
            want = (QC.qconv2d_plain(x, wk, *epi, **conv),
                    QC.qconv2d_fast_plain(x, wk, epi[0], mult, **conv))
            run = {"exact": lambda: QC.qconv2d_exact(x, wk, *epi, **conv),
                   "fast": lambda: QC.qconv2d_fast(x, wk, epi[0], mult,
                                                   **conv)}
            chosen = planner(n, *out_size(geom), ci, oc, kh, kw, stride, dil,
                             QC.alignment(wk))
            timings = []
            for p in plans(geom):
                QC.conv_plan = lambda *a, p=p: p
                got = (run["exact"](), run["fast"]())
                assert all(torch.equal(g, v) for g, v in zip(got, want)), p
                timings.append(dict(plan=p.name, threads=p.threads,
                                    blocks=p.blocks,
                                    **{k: graph_ms(f) for k, f in run.items()}))
            QC.conv_plan = planner
            mine = next(t for t in timings if t["plan"] == chosen.name)
            loop = timings[-1]
            best = {k: min(timings, key=lambda t: t[k]) for k in run}
            by_branch = {}
            for t in timings[:-1]:
                b = t["plan"].split("/")[0]
                if t["exact"] < by_branch.get(b, {"exact": 1e9})["exact"]:
                    by_branch[b] = t
            row = dict(shape=f"{n}x{h}x{w}x{ci}", oc=oc, taps=f"{kh}x{kw}",
                       stride=list(stride), calls=calls, plan=chosen.name,
                       plan_exact_ms=mine["exact"], plan_fast_ms=mine["fast"],
                       **{f"best_{k}": t["plan"] for k, t in best.items()},
                       **{f"best_{k}_ms": t[k] for k, t in best.items()},
                       **{f"best_{b}": t["plan"] for b, t in by_branch.items()},
                       **{f"best_{b}_exact_ms": t["exact"]
                          for b, t in by_branch.items()},
                       loop_exact_ms=loop["exact"], loop_fast_ms=loop["fast"])
            print("sweep: " + json.dumps(row), flush=True)
            rows.append(dict(row, timings=timings))
    finally:
        QC.conv_plan = planner
    total = {k: sum(r["calls"] * r[k] for r in rows)
             for k in ("plan_exact_ms", "plan_fast_ms", "best_exact_ms",
                       "best_fast_ms", "loop_exact_ms", "loop_fast_ms")}
    print("sweep total: " + json.dumps(dict(total, batch=args.batch)),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
