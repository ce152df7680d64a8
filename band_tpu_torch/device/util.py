"""Small sysfs/file helpers (reference: band/device/util.{h,cc}).

The reference wraps these for Android sysfs probing (thermal, cpufreq,
devfreq paths, root check).  On generic Linux hosts the same helpers
back CPU-cluster detection (cpu.py) and the resource monitor.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional


def read_file(path: str) -> Optional[str]:
    """Best-effort file read; None when missing/unreadable
    (reference: band/device/util.cc TryRead*)."""
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def read_int(path: str) -> Optional[int]:
    text = read_file(path)
    if text is None:
        return None
    try:
        return int(text.strip().split()[0])
    except (ValueError, IndexError):
        return None


def glob_paths(pattern: str) -> List[str]:
    return sorted(glob.glob(pattern))


def is_root() -> bool:
    """reference: band/device/util.cc IsRooted (su probing on Android);
    on a plain Linux host this is just the effective uid."""
    try:
        return os.geteuid() == 0
    except AttributeError:  # non-POSIX
        return False
