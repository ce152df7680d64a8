"""Bit-exact TFLite quantized SOFTMAX over the last axis, and its plain
version.

The JAX package ran this as XLA ops (``band_tpu/ops/quant.py:443
lut_softmax``, a ``lax.scan`` for the row sum), not as a Pallas kernel.
The port needs a kernel for it: exactness requires the float32 row sum
taken strictly left to right, which PyTorch's CUDA cumsum (a parallel
scan) and its CPU cumsum (a double accumulator) do not give, and the
plain loop below costs one launch per column on the card.  The CUDA
source is ``csrc/lut_softmax.cu``: a block per row for long rows, only
the float32 row sum serial, and a thread per row for short ones;
``softmax_plan`` picks the branch by depth.  At a few KB per call the
bytes bound nothing: the launch and the chain of ``depth`` dependent
float32 adds do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import quant as Q
from . import build
from .common import LaunchCount, check_tensor, on_card, require

launches = LaunchCount("lut_softmax")

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
_fn = None

THREAD, ROW = 0, 1      # the branches, as csrc/lut_softmax.cu numbers them
# The plan's rule, from sweep_softmax.py (PERF.md)
ROW_MIN_DEPTH = 32      # rows from this depth on take the row kernel
ROW_ELEMS = 8           # elements of a row per thread, about
ROW_MIN_THREADS = 64
ROW_MAX_THREADS = 256   # the row kernel's launch bound
THREAD_BLOCK = 64       # rows of a thread-kernel block
MAX_SMEM = 48 * 1024    # dynamic shared memory without opting in


class SoftmaxPlan(NamedTuple):
    branch: int    # THREAD or ROW
    threads: int   # threads of a block
    blocks: int
    smem: int      # dynamic shared memory bytes (row kernel)

    @property
    def name(self) -> str:
        return ("row" if self.branch == ROW else "thread") + \
            f"/{self.threads}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_smem(depth: int) -> int:
    """The row kernel's shared memory: the table, the e values (depth
    rounded up to 16 floats), and the row bytes staged at their offset
    in a 16-byte chunk (at most 15 bytes ahead of the row)."""
    return 4 * (256 + 16 * _cdiv(depth, 16)) + 16 * _cdiv(depth + 15, 16)


def thread_plan(rows: int) -> SoftmaxPlan:
    return SoftmaxPlan(THREAD, THREAD_BLOCK, _cdiv(rows, THREAD_BLOCK), 0)


def row_plan(rows: int, depth: int, threads: int = 0) -> SoftmaxPlan:
    """One block per row of ``threads`` threads (a multiple of 32 up to
    ROW_MAX_THREADS); by default one per ROW_ELEMS elements, in whole
    warps, from ROW_MIN_THREADS to ROW_MAX_THREADS."""
    if not threads:
        threads = min(ROW_MAX_THREADS, max(
            ROW_MIN_THREADS, 32 * _cdiv(depth, 32 * ROW_ELEMS)))
    return SoftmaxPlan(ROW, threads, rows, row_smem(depth))


@functools.lru_cache(maxsize=None)
def softmax_plan(rows: int, depth: int) -> SoftmaxPlan:
    """The branch of a softmax over ``rows`` rows of ``depth``: the row
    kernel from ROW_MIN_DEPTH on, while its shared memory fits, else the
    thread kernel."""
    if depth >= ROW_MIN_DEPTH and row_smem(depth) <= MAX_SMEM:
        return row_plan(rows, depth)
    return thread_plan(rows)


def lut_softmax_plain(x, table, out_scale, out_zp, out_dtype):
    """TFLite's integer softmax in plain PyTorch: e = table[255 - max +
    x], the row sum accumulated column by column in float32, then
    trunc(e * (1 / (sum * out_scale)) + 0.5) + out_zp, clamped."""
    out_dtype = Q.torch_dtype(out_dtype)
    qmin, qmax = Q.quantized_range(
        {torch.int8: "int8", torch.uint8: "uint8"}[out_dtype])
    xi = x.to(torch.int64)
    mx = xi.max(dim=-1, keepdim=True).values
    e = table.to(torch.float32)[255 - mx + xi]
    s = torch.zeros(e.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(e.shape[-1]):
        s = s + e[..., i]
    inv = torch.tensor(1.0, dtype=torch.float32, device=x.device) / (
        s * torch.tensor(out_scale, dtype=torch.float32, device=x.device))
    prob = e * inv.unsqueeze(-1)
    q = (prob + torch.tensor(0.5, dtype=torch.float32, device=x.device)).to(
        torch.int32) + int(out_zp)
    return q.clamp(qmin, qmax).to(out_dtype)


def lut_softmax(x, table, out_scale: float, out_zp: int, out_dtype):
    """Quantized softmax of int8/uint8 ``x`` over its last axis with the
    float32 exp table ``table`` [256] (quant.softmax_table).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    global _fn
    out_dtype = Q.torch_dtype(out_dtype)
    dev = x.device
    check_tensor(x, "x", (torch.int8, torch.uint8), x.dim(), dev)
    require(x.dim() >= 1 and x.shape[-1] >= 1, "softmax needs a last axis")
    check_tensor(table, "table", torch.float32, 1, dev)
    require(table.numel() == 256, "table must hold 256 entries")
    require(out_dtype in (torch.int8, torch.uint8),
            f"out_dtype must be int8 or uint8, got {out_dtype}")
    if not on_card(x):
        return lut_softmax_plain(x, table, out_scale, out_zp, out_dtype)
    depth = x.shape[-1]
    rows = x.numel() // depth
    qmin, qmax = (-128, 127) if out_dtype == torch.int8 else (0, 255)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    if rows == 0:
        return out
    require(rows < 2**31, "too many rows for one grid")
    if _fn is None:
        _fn = build.bind("lut_softmax", "band_lut_softmax", _ARGTYPES)
    p = softmax_plan(rows, depth)
    build.launch(_fn, dev, build.ptr(x), int(x.dtype == torch.uint8),
                 build.ptr(table), build.ptr(out), rows, depth,
                 float(out_scale), int(out_zp), qmin, qmax, p.branch,
                 p.threads, p.smem)
    launches.add()
    return out
