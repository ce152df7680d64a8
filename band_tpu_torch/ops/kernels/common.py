"""What the kernel wrappers share: launch counts and operand checks."""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from ..quant import ROUNDING_CODES


# per thread: the kernel calls being captured into a CUDA graph
_capture = threading.local()


class LaunchCount:
    """Launches of one kernel: a plain integer ``n``, raised by one
    where the wrapper launches its kernel and nowhere else.  A call made
    while the calling thread captures a CUDA graph (``recording``) runs
    nothing yet: it is tallied for the graph instead, and each replay of
    the graph adds its tally (``add(k)``)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        self._lock = threading.Lock()

    def add(self, k: int = 1) -> None:
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[self.name] = tally.get(self.name, 0) + k
            return
        with self._lock:
            self.n += k

    def reset(self) -> None:
        with self._lock:
            self.n = 0


@contextlib.contextmanager
def recording():
    """Tally, instead of count, the kernel calls this thread makes in the
    block (a CUDA graph capture); yields the {kernel name: calls} dict."""
    tally: dict = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int,
                 device: torch.device) -> None:
    require(isinstance(t, torch.Tensor), f"{name} must be a torch.Tensor")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    require(t.dtype in dtypes, f"{name} must be {dtypes}, got {t.dtype}")
    require(t.dim() == ndim, f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    require(t.device == device,
            f"{name} is on {t.device}, expected {device}")
    require(t.is_contiguous(), f"{name} must be contiguous")


def check_epilogue(bias: torch.Tensor, qm: torch.Tensor, shift: torch.Tensor,
                   n_out: int, device: torch.device, rounding: str,
                   out_dtype: torch.dtype) -> int:
    """Check the requant operands of ``n_out`` output channels; returns
    the qm/shift stride (0 for per-tensor, 1 for per-channel)."""
    check_tensor(bias, "bias", torch.int32, 1, device)
    require(bias.numel() == n_out, f"bias has {bias.numel()} != {n_out}")
    check_tensor(qm, "qm", torch.int32, 1, device)
    check_tensor(shift, "shift", torch.int32, 1, device)
    require(qm.numel() == shift.numel() and qm.numel() in (1, n_out),
            f"qm/shift must hold 1 or {n_out} entries")
    require(rounding in ROUNDING_CODES, f"unknown rounding {rounding!r}")
    require(out_dtype in (torch.int8, torch.uint8),
            f"out_dtype must be int8 or uint8, got {out_dtype}")
    return 0 if qm.numel() == 1 else 1


def check_fast_epilogue(bias: torch.Tensor, mult: torch.Tensor, n_out: int,
                        device: torch.device, out_dtype: torch.dtype) -> int:
    """Check the fast-numerics requant operands of ``n_out`` output
    channels; returns the mult stride (0 per-tensor, 1 per-channel)."""
    check_tensor(bias, "bias", torch.int32, 1, device)
    require(bias.numel() == n_out, f"bias has {bias.numel()} != {n_out}")
    check_tensor(mult, "mult", torch.float32, 1, device)
    require(mult.numel() in (1, n_out), f"mult must hold 1 or {n_out} entries")
    require(out_dtype in (torch.int8, torch.uint8),
            f"out_dtype must be int8 or uint8, got {out_dtype}")
    return 0 if mult.numel() == 1 else 1


def pair(v) -> Sequence[int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def alignment(*tensors) -> int:
    """The largest power of two up to 16 dividing every base address."""
    a = 16
    for t in tensors:
        p = t.data_ptr()
        a = min(a, p & -p)
    return a


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor (whose caller takes
    the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")
