"""ctypes loader for the native planner decision core, plan_core.cc.

Built on first use with the host compiler into ``band_tpu_torch/_build/``
(the library name carries a hash of the source, so an edited source
rebuilds and a second process reuses a finished build).  The engine
runs its Python DP, the reference this core is tested against, only
when the build or load failed, and then logs why.

The call path is scheduler-hot (O(window^2) DP calls per planner pass),
so argument marshaling is minimized: every array pointer is resolved
once at model registration and passed as a raw address."""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "plan_core.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_FLAGS = ["-O2", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libband_plan-{h.hexdigest()[:16]}.so")


def load() -> Optional[ctypes.CDLL]:
    """The native planner library, built on demand; None if it could not
    be built or loaded (``load_error()`` says why)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        from ...native_build import atomic_build

        path = lib_path()
        try:
            if not os.path.exists(path):
                atomic_build(["g++", *_FLAGS, _SRC], path)
            lib = ctypes.CDLL(path)
        except Exception as e:  # compiler missing or failing, bad library
            stderr = getattr(e, "stderr", b"") or b""
            _error = f"{e!r} {stderr.decode(errors='replace')[-2000:]}"
            return None
        i = ctypes.c_int
        vp = ctypes.c_void_p
        lib.band_plan_dp.argtypes = [
            i, i, vp, vp, vp, vp, vp,  # model table
            i, vp, vp, vp,             # workers
            vp, vp,                    # link-cost table + waiting
            i, i, i, ctypes.POINTER(ctypes.c_int),
        ]
        lib.band_plan_dp.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def load_error() -> Optional[str]:
    return _error


class PlanTables:
    """Flat per-model arrays the native DP consumes.

    Built once at model registration (keys sorted by begin unit, as
    band_plan_dp requires); `expected_us` is kept current by the
    LatencyEstimator's write-through binding, so scheduler-time calls
    marshal nothing but the waiting-time vector."""

    def __init__(self, num_units: int, keys, boundary_bytes: dict):
        self.keys = sorted(keys, key=lambda k: k.begin_unit)
        self.num_units = num_units
        n = len(self.keys)
        self.key_begin = np.asarray(
            [k.begin_unit for k in self.keys], np.int32
        )
        self.key_end = np.asarray([k.end_unit for k in self.keys], np.int32)
        self.key_worker = np.asarray(
            [k.worker_id for k in self.keys], np.int32
        )
        self.expected_us = np.full(n, -1, np.int64)
        self.boundary_bytes = np.asarray(
            [boundary_bytes.get(u, 0) for u in range(num_units)], np.int64
        )
        # raw addresses, resolved once (the arrays above stay referenced
        # by self for their lifetime)
        self.arg_prefix = (
            num_units, n,
            self.key_begin.ctypes.data, self.key_end.ctypes.data,
            self.key_worker.ctypes.data, self.expected_us.ctypes.data,
            self.boundary_bytes.ctypes.data,
        )


def card_key(device: torch.device) -> int:
    """A worker's card identity for transfer costing: the CUDA index,
    -1 for the CPU.  A ``torch.device`` is not a singleton, so workers
    are compared by this key, never by object identity: two workers on
    ``cuda:0`` share one card and hop for free."""
    if device.type == "cuda":
        return device.index if device.index is not None else 0
    return -1


class WorkerTables:
    """Per-worker link-class facts for transfer costing."""

    def __init__(self, is_host: Sequence[bool],
                 devices: Sequence[torch.device],
                 procs: Optional[Sequence[int]] = None):
        self.n = len(is_host)
        self.is_host = np.asarray(is_host, np.uint8)
        self.dev = np.asarray([card_key(d) for d in devices], np.int64)
        # each worker's process (a mesh's: its first device's), so that a
        # hop between processes is priced as DCN
        self.proc = np.asarray(
            procs if procs is not None else [0] * self.n, np.int32)
        self.arg = (
            self.n, self.is_host.ctypes.data, self.dev.ctypes.data,
            self.proc.ctypes.data,
        )


def plan_dp(lib, model: PlanTables, workers: WorkerTables,
            link_costs: np.ndarray, waiting_us: np.ndarray,
            start_unit: int, prev_worker: int, batch: int = 1):
    """Run the native DP; returns (first-hop SubgraphKey | None, end µs).
    `link_costs` is the engine's LinkCostTable.table (4x2 int64) — the
    same array the Python DP reads, passed by pointer.  `batch` scales
    the hop bytes (a batched window's continuation moves B x the
    boundary activations)."""
    out = ctypes.c_int(-1)
    best = lib.band_plan_dp(
        *model.arg_prefix, *workers.arg, link_costs.ctypes.data,
        waiting_us.ctypes.data,
        start_unit, prev_worker, batch, ctypes.byref(out),
    )
    if best < 0 or out.value < 0:
        return None, 0
    return model.keys[out.value], int(best)
