"""Time the int8 depthwise conv kernels (B3 and its fast instance) under
every plan variant (kernel size and stride, output strip, block), at the
depthwise shapes of a MobileNetV2 1.0/224 request, on one card.

    python -m band_tpu_torch.ops.kernels.sweep_dwconv [--batch 1] [--out F]

Each (shape, variant, block) is held byte-equal to the plain version and
timed as chip_smoke.py times a kernel: a CUDA graph of 20 launches,
replayed, CUDA events.  The general branch (one thread per output byte)
is timed beside them.  Prints one JSON line per shape: dwconv_plan's
choice and its time, the fastest variant found for each numerics, and
the general branch's time; with --out, every timing as JSON.  Needs a
CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import qdwconv as QD
from .sweep_gemm import capture_calls, graph_ms

BLOCKS = (32, 64, 128, 256)  # threads of a block, at most
BLOCK_STRIPS = (1, 8, 32)    # strips of a block, at most


def dwconv_shapes(batch, model="mobilenet_v2_int8"):
    """Geometry -> calls of every depthwise conv of one run of ``model``
    (a tests/data model) at ``batch``, from the port's program run on the
    CPU.  A geometry is (n, h, w, c, mult, kh, kw, stride, dilation,
    padding)."""
    def key(x, w, *_, **kw):
        return (*x.shape, w.shape[1] // x.shape[3], kw["kh"], kw["kw"],
                tuple(kw["stride"]), tuple(kw["dilation"]),
                tuple(tuple(p) for p in kw["padding"]))

    return capture_calls(model, batch, "qdwconv2d_exact", key)


def out_size(geom):
    """(oh, ow) of a geometry."""
    n, h, w, c, mult, kh, kw, (sh, sw), (dh, dw), ((pt, pb), (pl, pr)) = geom
    return ((h + pt + pb - (kh - 1) * dh - 1) // sh + 1,
            (w + pl + pr - (kw - 1) * dw - 1) // sw + 1)


def plans(geom):
    """Every plan the kernel takes for this geometry: each strip variant
    that fits it under each block shape, and the general loop."""
    n, h, w, c, mult, kh, kw, (sh, sw), dil, _ = geom
    oh, ow = out_size(geom)
    seen = set()
    if mult == 1 and dil == (1, 1) and c % QD.VEC == 0:
        for i, (k, s, _) in enumerate(QD.VARIANTS):
            if k == kh == kw and s == sw:
                for t in BLOCKS:
                    for bs in BLOCK_STRIPS:
                        p = QD.strip_plan(i, n, oh, ow, c, t, bs)
                        if (p.variant, p.block) not in seen:
                            seen.add((p.variant, p.block))
                            yield p
    yield QD.general_plan(n, oh, ow, c * mult)


def operands(geom, rng, dev):
    """x, w, (bias, qm, shift), mult of a geometry: random int8 data and
    multipliers that map the accumulator's spread to ~30 units."""
    from .. import quant as Q

    n, h, w, c, mult, kh, kw, *_ = geom
    co = c * mult

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    m = 30.0 / (3.0 * 73.0 * 73.0) * rng.uniform(0.5, 2.0, co)
    qm, sh = Q.quantize_multipliers(m)
    bias = rng.integers(-20000, 20000, co).astype(np.int32)
    return (t(rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)),
            t(rng.integers(-128, 128, (kh * kw, co), dtype=np.int8)),
            (t(bias), t(qm), t(sh)), t(m.astype(np.float32)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_dwconv: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    planner = QD.dwconv_plan
    rows = []
    try:
        for geom, calls in sorted(dwconv_shapes(args.batch).items(),
                                  key=lambda kv: -np.prod(kv[0][:4])):
            n, h, w, c, mult, kh, kw, stride, dil, pad = geom
            x, wk, epi, mult_f = operands(geom, rng, dev)
            conv = dict(kh=kh, kw=kw, stride=stride, dilation=dil,
                        padding=pad, x_zp=-3)
            want = (QD.qdwconv2d_plain(x, wk, *epi, **conv),
                    QD.qdwconv2d_fast_plain(x, wk, epi[0], mult_f, **conv))
            run = {"exact": lambda: QD.qdwconv2d_exact(x, wk, *epi, **conv),
                   "fast": lambda: QD.qdwconv2d_fast(x, wk, epi[0], mult_f,
                                                     **conv)}
            chosen = planner(n, *out_size(geom), c, mult, kh, kw, stride,
                             dil, QD.alignment(x, wk))
            timings = []
            for p in plans(geom):
                QD.dwconv_plan = lambda *a, p=p: p
                got = (run["exact"](), run["fast"]())
                assert all(torch.equal(g, v) for g, v in zip(got, want)), p
                timings.append(dict(plan=p.name, variant=p.variant,
                                    block=list(p.block),
                                    **{k: graph_ms(f) for k, f in run.items()}))
            QD.dwconv_plan = planner
            mine = next(t for t in timings if t["variant"] == chosen.variant
                        and tuple(t["block"]) == chosen.block)
            general = timings[-1]
            best = {k: min(timings, key=lambda t: t[k]) for k in run}
            row = dict(shape=f"{n}x{h}x{w}x{c}", stride=list(stride),
                       calls=calls, plan=chosen.name,
                       plan_exact_ms=mine["exact"], plan_fast_ms=mine["fast"],
                       **{f"best_{k}": t["plan"] for k, t in best.items()},
                       **{f"best_{k}_ms": t[k] for k, t in best.items()},
                       general_exact_ms=general["exact"],
                       general_fast_ms=general["fast"])
            print("sweep: " + json.dumps(row), flush=True)
            rows.append(dict(row, timings=timings))
    finally:
        QD.dwconv_plan = planner
    total = {k: sum(r["calls"] * r[k] for r in rows)
             for k in ("plan_exact_ms", "plan_fast_ms", "best_exact_ms",
                       "best_fast_ms", "general_exact_ms", "general_fast_ms")}
    print("sweep total: " + json.dumps(dict(total, batch=args.batch)),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
