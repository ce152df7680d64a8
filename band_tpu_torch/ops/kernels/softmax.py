"""Bit-exact TFLite quantized SOFTMAX over the last axis, and its plain
version.

The JAX package ran this as XLA ops (``band_tpu/ops/quant.py:443
lut_softmax``, a ``lax.scan`` for the row sum), not as a Pallas kernel.
The port needs a kernel for it: exactness requires the float32 row sum
taken strictly left to right, which PyTorch's CUDA cumsum (a parallel
scan) and its CPU cumsum (a double accumulator) do not give, and the
plain loop below costs one launch per column on the card.  The CUDA
source is ``csrc/lut_softmax.cu``, one thread per row; at a few KB per
call, launch latency bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import quant as Q
from . import build
from .common import LaunchCount, check_tensor, on_card, require

launches = LaunchCount("lut_softmax")

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
_fn = None


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
    if _fn is None:
        _fn = build.bind("lut_softmax", "band_lut_softmax", _ARGTYPES)
    build.launch(_fn, dev, build.ptr(x), int(x.dtype == torch.uint8),
                 build.ptr(table), build.ptr(out), rows, depth,
                 float(out_scale), int(out_zp), qmin, qmax)
    launches.add()
    return out
