"""ctypes loader for the native image kernels, image_ops.cc.

Built on first use with the host compiler into ``band_tpu_torch/_build/``.
The library's name carries a hash of the source, the flags and the host
CPU, so an edited source rebuilds, a second process reuses a finished
build, and a library built for another CPU (``-march=native``) is never
loaded.  A failed build or load raises: the operators do not fall back
to their numpy paths behind the caller's back.

Flags: ``-O3 -march=native`` as band_tpu builds it, plus
``-ffp-contract=off``, so the compiler never fuses the bilinear
resize's ``a + (b - a) * w`` into an FMA: the resize then gives the same
bytes on every x86-64 host, with or without FMA units.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "image_ops.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> str:
    """The host CPU's model and feature flags (what -march=native sees)."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [line for line in f
                    if line.startswith(("model name", "flags"))]
        return "".join(sorted(set(keep)))
    except OSError:
        return platform.processor() or platform.machine()


def lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR,
                        f"libband_image_ops-{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The native kernel library, built on demand; raises if it cannot
    be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ...native_build import atomic_build

        path = lib_path()
        if not os.path.exists(path):
            atomic_build(["g++", *FLAGS, _SRC], path)
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        for name, args in (
            ("resize_bilinear_u8", [u8p, i, i, i, u8p, i, i]),
            ("resize_nearest_u8", [u8p, i, i, i, u8p, i, i]),
            ("nv_to_rgb_u8", [u8p, u8p, i, i, i, u8p]),
            ("i420_to_rgb_u8", [u8p, u8p, u8p, i, i, u8p]),
            ("rgb_to_gray_u8", [u8p, i, u8p]),
            ("rgba_to_rgb_u8", [u8p, i, u8p]),
            ("rotate_u8", [u8p, i, i, i, i, u8p]),
            ("flip_u8", [u8p, i, i, i, i, u8p]),
            ("normalize_u8_f32", [u8p, i, ctypes.c_float, ctypes.c_float,
                                  f32p]),
            ("normalize_u8_f32_perchannel", [u8p, i, i, f32p, f32p, f32p]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
        return _lib
