"""Builds the hand-written CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, for
Hopper (``sm_90a``), under ``band_tpu_torch/_build/``.  Library names
carry a hash of the sources, so a second process reuses a finished
build and an edited source rebuilds.  Nothing is built at import: the
first kernel launch builds, and a CPU-only machine never does.

A build or load failure raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> Dict[str, str]:
    """Kernel library name -> its .cu source."""
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    }


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for p in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str, src: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(src)}.so")


def build_all(verbose: bool = False) -> float:
    """Compile every kernel library that is not built yet, one nvcc
    process per source, all running at once.  Returns the seconds spent.
    A file lock in the build directory keeps two processes (a mesh's on
    one card) from building at once: the second finds the first's
    libraries."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock, open(os.path.join(BUILD_DIR, ".kernels.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        t0 = time.perf_counter()
        todo = {
            name: (src, _lib_path(name, src))
            for name, src in sources().items()
            if not os.path.exists(_lib_path(name, src))
        }
        if todo:
            nvcc = nvcc_path()
            procs = []
            for name, (src, out) in todo.items():
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
                if verbose:
                    cmd.insert(1, "-Xptxas=-v")
                procs.append((name, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for name, out, tmp, p in procs:
                log, _ = p.communicate()
                if p.returncode != 0:
                    failed.append(f"{name}:\n{log}")
                    continue
                if verbose and log.strip():
                    print(f"[nvcc {name}]\n{log.strip()}")
                os.replace(tmp, out)
            if failed:
                raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = sources().get(name)
    if src is None:
        raise RuntimeError(f"no kernel source {name}.cu in {CSRC}")
    path = _lib_path(name, src)
    if not os.path.exists(path):
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            _libs[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """A C entry point of library ``name`` with its argument types set
    (pointers and the stream as c_void_p, or ctypes would cut them to
    32 bits) and an int return: the launch's cudaGetLastError()."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` followed by PyTorch's
    current stream on ``device``, with ``device`` current for the
    calling thread (the CUDA runtime launches on the thread's current
    device); raise if it returns a CUDA error code."""
    import torch

    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
