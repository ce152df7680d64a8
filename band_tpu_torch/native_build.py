"""Shared native-library build helper (host compiler).

A builder publishes atomically: compile to a pid-suffixed temp path,
then `os.replace` into place, so a concurrent process can never dlopen
a half-written library.  Stale temp litter from crashed builds is swept
on the way in.  Used by the planner's decision core
(runtime/native/plan_core.cc); the CUDA kernels have their own nvcc
builder (ops/kernels/build.py).
"""

from __future__ import annotations

import glob
import os
import subprocess
import time
from typing import Sequence

# temp litter younger than this may belong to a live concurrent build
# in another process; only genuinely stale leftovers are swept
_STALE_TMP_SECONDS = 600.0


def atomic_build(cmd_prefix: Sequence[str], lib_path: str,
                 timeout: float = 120.0) -> None:
    """Run `cmd_prefix + ["-o", <tmp>]`, then atomically publish
    `lib_path`; a failed build raises (CalledProcessError carries the
    compiler's stderr)."""
    now = time.time()
    for stale in glob.glob(f"{lib_path}.tmp*"):
        try:
            if now - os.path.getmtime(stale) > _STALE_TMP_SECONDS:
                os.unlink(stale)
        except OSError:
            pass
    os.makedirs(os.path.dirname(os.path.abspath(lib_path)), exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    try:
        subprocess.run(
            list(cmd_prefix) + ["-o", tmp],
            check=True,
            capture_output=True,
            timeout=timeout,
        )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
