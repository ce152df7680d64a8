"""Build libband_tpu_torch_c.so (the C ABI over the engine).

Usage: ``python -m band_tpu_torch.c.build [out_dir]`` (default
``band_tpu_torch/_build/``); also importable (``build()``) so tests and
programs build on first use.  Links against the interpreter's shared
libpython, so the library can be used from plain C programs (reference
analogue: script/build_c_api.py driving bazel).  A program linked
against it runs the embedded interpreter with PYTHONPATH naming the
repository and the site-packages that hold torch (``python_path()``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
LIB_NAME = "band_tpu_torch_c"


def build(out_dir: Optional[str] = None, quiet: bool = False) -> str:
    """Build (or reuse a build newer than its sources) and return the
    library's path; a failed build raises with the compiler's output."""
    out_dir = out_dir or BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(HERE, "band_c.cc")
    out = os.path.join(out_dir, f"lib{LIB_NAME}.so")
    newest = max(os.path.getmtime(p)
                 for p in (src, os.path.join(HERE, "band_c.h")))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError(
            "the C ABI embeds CPython and needs a shared libpython; this "
            f"interpreter ({sys.executable}) was built without one")
    include = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ldver = sysconfig.get_config_var("LDVERSION")
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        src,
        f"-I{include}",
        f"-L{libdir}",
        f"-lpython{ldver}",
        f"-Wl,-rpath,{libdir}",
    ]
    if not quiet:
        print(" ".join(cmd + ["-o", out]))
    from ..native_build import atomic_build

    try:
        atomic_build(cmd, out, timeout=300)
    except subprocess.CalledProcessError as e:
        if e.stderr:  # surface the compiler diagnostics
            sys.stderr.write(e.stderr.decode("utf-8", "replace"))
        raise
    return out


def build_example(name: str, out_dir: Optional[str] = None,
                  link_library: bool = True) -> str:
    """Compile ``example/<name>.c`` (against the library, built first,
    unless ``link_library`` is false: the HTTP client needs none) and
    return the program's path."""
    out_dir = out_dir or BUILD_DIR
    cmd = ["gcc", "-O2", os.path.join(HERE, "example", f"{name}.c")]
    if link_library:
        lib_dir = os.path.dirname(build(out_dir, quiet=True))
        cmd += [f"-I{HERE}", f"-L{lib_dir}", f"-l{LIB_NAME}",
                f"-Wl,-rpath,{lib_dir}"]
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, f"band_c_{name}")
    from ..native_build import atomic_build

    atomic_build(cmd, exe)
    return exe


def python_path() -> str:
    """PYTHONPATH for a C program that embeds this interpreter: the
    repository, then every directory of this process's ``sys.path`` (a
    virtual environment's site-packages is not on the base
    interpreter's path)."""
    repo = os.path.dirname(os.path.dirname(HERE))
    paths = [repo] + [p for p in sys.path if p and os.path.isdir(p)]
    return os.pathsep.join(dict.fromkeys(paths))


if __name__ == "__main__":
    print(build(sys.argv[1] if len(sys.argv) > 1 else None))
