"""Bit-exact TFLite quantized ADD and SUB of two same-shape int8 or uint8
operands, and its plain version.

The JAX package ran this as XLA int64 ops (``band_tpu/ops/lowerings.py``
ADD/SUB), not as a Pallas kernel; the port's plain version is the same
chain of eager int64 PyTorch ops, about 30 launches an op on the card.
The CUDA source is ``csrc/qaddsub.cu``: one launch, three bytes an
element moved once, every intermediate in registers.  ``ops/lowerings.py
_addsub`` routes same-shape contiguous operands here and keeps the chain
(``qaddsub_plain``) for a broadcast operand.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import quant as Q
from . import build
from .common import LaunchCount, alignment, on_card, require

launches = LaunchCount("qaddsub")

# the prepared scalars of an exact quantized ADD/SUB (ops/lowerings.py
# _prepare_addsub), the keyword arguments of qaddsub and qaddsub_plain
PARAMS = ("zp1", "zp2", "zpo", "qm1", "sh1", "qm2", "sh2", "qmo", "sho",
          "left_shift", "qmin", "qmax")

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 16
             + [ctypes.c_void_p])
_fn = None

THREADS = 256        # a block's threads (csrc/qaddsub.cu kAddSubThreads)
VEC = 16             # elements a thread takes through 16-byte accesses
BLOCKS_PER_SM = 4    # the grid's cap, with the grid-stride loop
_INT8 = (torch.int8, torch.uint8)
_SMALL = 1 << 24     # the zero points' and clamp bounds' range


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def addsub_blocks(n: int, vec: bool, sms: int) -> int:
    """The grid of ``n`` elements: a thread per 16-element chunk (vec) or
    per element, up to BLOCKS_PER_SM blocks an SM; at least one block,
    whose threads take a tail shorter than a chunk."""
    items = n // VEC if vec else n
    return max(1, min(_cdiv(items, THREADS), sms * BLOCKS_PER_SM))


def qaddsub_plain(x1, x2, *, zp1, zp2, zpo, qm1, sh1, qm2, sh2, qmo, sho,
                  left_shift, qmin, qmax, sign, out_dtype, rounding=None):
    """TFLite's exact ADD (sign +1) or SUB (-1) as int64 PyTorch ops: both
    inputs rescaled to a common scale, (x - zp) << left_shift through
    MBQM, summed or subtracted, rescaled to the output through MBQM,
    + zpo, clamped; operands that broadcast are taken as they broadcast."""
    a1 = x1.to(torch.int64) - int(zp1)
    a2 = x2.to(torch.int64) - int(zp2)
    s1 = Q.multiply_by_quantized_multiplier(
        a1 << int(left_shift), int(qm1), int(sh1), rounding)
    s2 = Q.multiply_by_quantized_multiplier(
        a2 << int(left_shift), int(qm2), int(sh2), rounding)
    s1, s2 = s1.to(torch.int64), s2.to(torch.int64)
    raw = s1 + s2 if sign > 0 else s1 - s2
    out = Q.multiply_by_quantized_multiplier(
        raw, int(qmo), int(sho), rounding).to(torch.int64) + int(zpo)
    return out.clamp(int(qmin), int(qmax)).to(Q.torch_dtype(out_dtype))


def qaddsub(x1, x2, *, zp1, zp2, zpo, qm1, sh1, qm2, sh2, qmo, sho,
            left_shift, qmin, qmax, sign, out_dtype, rounding=None):
    """Exact quantized ADD (sign +1) or SUB (-1) of two int8/uint8 tensors
    of one shape, both contiguous on one device, as ``out_dtype`` (int8 or
    uint8).  The rounding is ``Q.DEFAULT_ROUNDING`` read at the call
    unless given.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    global _fn
    out_dtype = Q.torch_dtype(out_dtype)
    rounding = rounding or Q.DEFAULT_ROUNDING
    for name, t in (("x1", x1), ("x2", x2)):
        require(isinstance(t, torch.Tensor), f"{name} must be a torch.Tensor")
        require(t.dtype in _INT8, f"{name} must be {_INT8}, got {t.dtype}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(x1.shape == x2.shape,
            f"x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} differ in shape")
    require(x1.device == x2.device,
            f"x2 is on {x2.device}, expected {x1.device}")
    require(out_dtype in _INT8,
            f"out_dtype must be int8 or uint8, got {out_dtype}")
    require(sign in (1, -1), f"sign must be +1 or -1, got {sign}")
    require(rounding in Q.ROUNDING_CODES, f"unknown rounding {rounding!r}")
    hi_shift = 30 if rounding == "single" else 31
    for name, sh in (("sh1", sh1), ("sh2", sh2), ("sho", sho)):
        require(-31 <= int(sh) <= hi_shift,
                f"{name} {int(sh)} outside [-31, {hi_shift}]")
    for name, qm in (("qm1", qm1), ("qm2", qm2), ("qmo", qmo)):
        require(0 <= int(qm) < 2**31, f"{name} {int(qm)} outside [0, 2^31)")
    require(0 <= int(left_shift) <= 31,
            f"left_shift {int(left_shift)} outside [0, 31]")
    for name, v in (("zp1", zp1), ("zp2", zp2), ("zpo", zpo),
                    ("qmin", qmin), ("qmax", qmax)):
        require(-_SMALL <= int(v) <= _SMALL,
                f"{name} {int(v)} outside [-2^24, 2^24]")
    kw = dict(zp1=zp1, zp2=zp2, zpo=zpo, qm1=qm1, sh1=sh1, qm2=qm2, sh2=sh2,
              qmo=qmo, sho=sho, left_shift=left_shift, qmin=qmin, qmax=qmax,
              sign=sign, out_dtype=out_dtype, rounding=rounding)
    if not on_card(x1):
        return qaddsub_plain(x1, x2, **kw)
    dev = x1.device
    out = torch.empty(x1.shape, dtype=out_dtype, device=dev)
    n = x1.numel()
    if n == 0:
        return out
    if _fn is None:
        _fn = build.bind("qaddsub", "band_qaddsub", _ARGTYPES)
    vec = alignment(x1, x2, out) == 16
    build.launch(_fn, dev, build.ptr(x1), int(x1.dtype == torch.uint8),
                 build.ptr(x2), int(x2.dtype == torch.uint8), build.ptr(out),
                 n, int(zp1), int(zp2), int(zpo), int(qm1), int(sh1),
                 int(qm2), int(sh2), int(qmo), int(sho), int(left_shift),
                 int(sign), int(qmin), int(qmax), Q.ROUNDING_CODES[rounding],
                 int(vec), addsub_blocks(n, vec, _sms(dev.index or 0)))
    launches.add()
    return out
