"""Where the time of a latency-bound kernel goes, without a profiler:
build copies of a kernel source with one phase removed, and time each
beside the whole kernel on the card.

    python -m band_tpu_torch.ops.kernels.knockout

The copies go under band_tpu_torch/_build/knockout/ and are timed as
chip_smoke.py times a kernel (a CUDA graph of 20 launches, replayed).
A copy computes the wrong answer by design; only the whole kernel is
checked against its plain version.  Phases:

- csrc/qconv.cu, the direct conv (B2 exact and fast), at the slice
  models' stem and small-Ci shapes: ``no_stage`` (the round trip that
  stages the weights and the patch), ``no_taps`` (the __dp4a loop),
  ``trivial_ep`` (the requant replaced by a byte of the sum);
- csrc/lut_softmax.cu, the row kernel, at depths 256, 1000 and 4000:
  ``no_sum`` (the serial float32 row sum), ``no_epass`` (the e values),
  ``no_out`` (the output pass).

Prints one JSON line per shape.  Needs a CUDA card; without one it exits
non-zero.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import quant as Q
from . import build, qconv as QC, softmax as SM
from .sweep_gemm import graph_ms


def _cut(src, old, new):
    if old not in src:
        raise RuntimeError(f"knockout: {old!r} not in the source")
    return src.replace(old, new)


def _variants(name):
    """Copies of csrc/<name>.cu, each with one phase removed."""
    src = open(os.path.join(build.CSRC, f"{name}.cu")).read()
    if name == "qconv":
        a = src.index("  for (int round = 0;")
        b = src.index("  // this thread's pixels: their offsets in the patch")
        taps = "#pragma unroll\n  for (int dy = 0; dy < kh; ++dy) {"
        return {
            "whole": src,
            "no_stage": src[:a] + src[b:],
            "no_taps": _cut(src, taps, "  if (false)\n" + taps),
            "trivial_ep": _cut(
                src, "byte_at(ep.apply(acc[j][c], rs[j], prm[c]), c % 4)",
                "byte_at(static_cast<int8_t>(acc[j][c] + prm[c].bias), "
                "c % 4)"),
        }
    return {
        "whole": src,
        "no_sum": _cut(src, "for (int k = 0; k < blocks; ++k) {",
                       "for (int k = 0; k < 0; ++k) {"),
        "no_epass": _cut(src, "for (int i = 4 * tid; i < row_e_floats(depth);",
                         "for (int i = 4 * tid; i < 0;"),
        "no_out": _cut(src, "for (int j = tid; j < owords; j += nt) {",
                       "for (int j = tid; j < 0; j += nt) {"),
    }


def _build(name, variants):
    """Compile every copy at once; returns {variant: CDLL}."""
    out = os.path.join(build.BUILD_DIR, "knockout")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for k, src in variants.items():
        cu = os.path.join(out, f"{name}_{k}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[k] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"knockout: {name}_{k} failed to build\n{log}")
        libs[k] = ctypes.CDLL(os.path.join(out, f"{name}_{k}.so"))
    return libs


def _bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def conv_rows(dev, rng):
    libs = _build("qconv", _variants("qconv"))
    shapes = [(1, 224, 224, 3, 32, (2, 2), ((0, 1), (0, 1))),
              (8, 224, 224, 3, 32, (2, 2), ((0, 1), (0, 1))),
              (1, 32, 32, 3, 16, (1, 1), ((1, 1), (1, 1))),
              (1, 16, 16, 16, 16, (1, 1), ((1, 1), (1, 1)))]
    saved = QC._fn, QC._fast_fn
    try:
        for n, h, w, ci, oc, st, pad in shapes:
            x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, ci),
                                              dtype=np.int8)).to(dev)
            wk = torch.from_numpy(rng.integers(-128, 128, (9 * ci, oc),
                                               dtype=np.int8)).to(dev)
            bias = torch.zeros(oc, dtype=torch.int32, device=dev)
            qm = torch.full((oc,), 1 << 30, dtype=torch.int32, device=dev)
            sh = torch.full((oc,), -8, dtype=torch.int32, device=dev)
            mult = torch.full((oc,), 2.0 ** -9, dtype=torch.float32,
                              device=dev)
            kw = dict(kh=3, kw=3, stride=st, padding=pad, x_zp=-3)
            row = {}
            for k, lib in libs.items():
                QC._fn = _bind(lib, "band_qconv2d_exact", QC._ARGTYPES)
                QC._fast_fn = _bind(lib, "band_qconv2d_fast",
                                    QC._FAST_ARGTYPES)
                if k == "whole":
                    assert torch.equal(
                        QC.qconv2d_exact(x, wk, bias, qm, sh, **kw),
                        QC.qconv2d_plain(x, wk, bias, qm, sh, **kw))
                row[k] = {
                    "exact_ms": graph_ms(lambda: QC.qconv2d_exact(
                        x, wk, bias, qm, sh, **kw)),
                    "fast_ms": graph_ms(lambda: QC.qconv2d_fast(
                        x, wk, bias, mult, **kw))}
            print("knockout: " + json.dumps(
                {"kernel": "qconv", "shape": f"{n}x{h}x{w}x{ci}", "oc": oc,
                 "stride": list(st), **row}), flush=True)
    finally:
        QC._fn, QC._fast_fn = saved


def softmax_rows(dev, rng):
    libs = _build("lut_softmax", _variants("lut_softmax"))
    table = torch.from_numpy(Q.softmax_table(0.0625, 1.0)).to(dev)
    saved = SM._fn
    try:
        for rows, depth in ((1, 256), (1, 1000), (8, 1000), (1, 4000)):
            x = torch.from_numpy(rng.integers(-128, 128, (rows, depth),
                                              dtype=np.int8)).to(dev)

            def run():
                return SM.lut_softmax(x, table, 1.0 / 256, -128, torch.int8)

            row = {}
            for k, lib in libs.items():
                SM._fn = _bind(lib, "band_lut_softmax", SM._ARGTYPES)
                if k == "whole":
                    assert torch.equal(run(), SM.lut_softmax_plain(
                        x, table, 1.0 / 256, -128, torch.int8))
                row[k] = graph_ms(run)
            print("knockout: " + json.dumps(
                {"kernel": "lut_softmax", "shape": [rows, depth],
                 "plan": SM.softmax_plan(rows, depth).name, **row}),
                flush=True)
    finally:
        SM._fn = saved


def main():
    if not torch.cuda.is_available():
        print("knockout: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    z = torch.zeros(1, device=dev)
    print("knockout: " + json.dumps(
        {"launch_floor_ms": graph_ms(lambda: z.add_(1))}), flush=True)
    conv_rows(dev, rng)
    softmax_rows(dev, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
