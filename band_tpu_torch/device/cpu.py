"""Host CPU topology + thread affinity (reference: band/device/cpu.{h,cc}).

Role in the GPU build: every worker — GPU or host — is fed by a host
dispatch thread, and the reference pins those threads (and the
planner) to configured core sets, with big/LITTLE clusters detected by
per-core maximum frequency (band/device/cpu.cc:326-389).  On Linux we
honor the exact same config surface (`cpu_masks`, `planner_cpu_masks`)
through ``sched_setaffinity``; where the reference only accepts the
four mask flags we additionally accept explicit core lists ("0,2-3")
since server hosts are usually homogeneous (ALL == BIG there, like the
reference's non-mobile fallback, cpu.cc:383-386).

Note the scope honestly: affinity here pins the *dispatch/planner*
threads (what the reference pins for its GPU/DSP/NPU workers too,
script/config_samples/benchmark_heft.json workers[2:]); PyTorch's CPU
compute pool is process-global, so a host worker's `num_threads` is
carried in the spec for schema parity but per-worker compute-thread
counts are not enforceable per dispatch.
"""

from __future__ import annotations

import os
import threading
from enum import Enum
from typing import Dict, Iterable, Optional

from . import util


class CPUMaskFlag(str, Enum):
    """reference: band/common.h:100-106 (kAll/kLittle/kBig/kPrimary)."""

    ALL = "all"
    LITTLE = "little"
    BIG = "big"
    PRIMARY = "primary"


class CpuSet:
    """Mutable set of host core indices (reference: band/device/cpu.h:21-42)."""

    def __init__(self, cpus: Iterable[int] = ()) -> None:
        self._cpus = set(int(c) for c in cpus)

    def enable(self, cpu: int) -> None:
        self._cpus.add(int(cpu))

    def disable(self, cpu: int) -> None:
        self._cpus.discard(int(cpu))

    def disable_all(self) -> None:
        self._cpus.clear()

    def is_enabled(self, cpu: int) -> bool:
        return int(cpu) in self._cpus

    def num_enabled(self) -> int:
        return len(self._cpus)

    @property
    def cpus(self) -> frozenset:
        return frozenset(self._cpus)

    def mask_flag(self) -> Optional[CPUMaskFlag]:
        """Which canonical mask this set equals, if any
        (reference: CpuSet::GetCPUMaskFlag)."""
        for flag, s in _masks().items():
            if s == self:
                return flag
        return None

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CpuSet) and self._cpus == other._cpus

    def __hash__(self) -> int:
        return hash(frozenset(self._cpus))

    def __repr__(self) -> str:
        return f"CpuSet({sorted(self._cpus)})"


def cpu_count() -> int:
    """reference: band/device/cpu.cc GetCPUCount (proc/cpuinfo scan)."""
    return os.cpu_count() or 1


def _max_freq_khz(cpu: int) -> int:
    """Maximum frequency of a core in kHz, -1 if unknown.

    Mirrors the reference's fallback chain (band/device/cpu.cc:172-240):
    cpufreq time_in_state stats first, then cpuinfo_max_freq.
    """
    for path in (
        f"/sys/devices/system/cpu/cpufreq/stats/cpu{cpu}/time_in_state",
        f"/sys/devices/system/cpu/cpu{cpu}/cpufreq/stats/time_in_state",
    ):
        text = util.read_file(path)
        if text is not None:
            best = -1
            for line in text.splitlines():
                parts = line.split()
                if parts:
                    try:
                        best = max(best, int(parts[0]))
                    except ValueError:
                        break
            if best > 0:
                return best
    val = util.read_int(f"/sys/devices/system/cpu/cpu{cpu}/cpufreq/cpuinfo_max_freq")
    return val if val is not None else -1


_mask_lock = threading.Lock()
_mask_cache: Optional[Dict[CPUMaskFlag, CpuSet]] = None


def _masks() -> Dict[CPUMaskFlag, CpuSet]:
    """Detect ALL/LITTLE/BIG/PRIMARY masks once
    (reference: SetupThreadAffinityMasks, band/device/cpu.cc:326-389)."""
    global _mask_cache
    with _mask_lock:
        if _mask_cache is not None:
            return _mask_cache
        n = cpu_count()
        all_set = CpuSet(range(n))
        little, big, primary = CpuSet(), CpuSet(), CpuSet()
        freqs = [_max_freq_khz(i) for i in range(n)]
        fmax = max(freqs)
        # cores with unreadable frequency (-1, e.g. missing cpufreq sysfs
        # in a container) count as fast, not LITTLE — a homogeneous host
        # with one unreadable core must not grow a phantom little cluster
        freqs = [fmax if f < 0 else f for f in freqs]
        fmin = min(freqs)
        medium = (fmin + fmax) // 2
        if medium == fmax:
            # homogeneous (or frequencies unreadable): every core is big
            # (reference: cpu.cc:352-358 and the non-mobile fallback :383-386)
            big = CpuSet(range(n))
        else:
            for i, f in enumerate(freqs):
                if f < medium:
                    little.enable(i)
                elif f == fmax:
                    primary.enable(i)
                else:
                    big.enable(i)
            if big.num_enabled() == 0:
                big, primary = primary, CpuSet()
        _mask_cache = {
            CPUMaskFlag.ALL: all_set,
            CPUMaskFlag.LITTLE: little,
            CPUMaskFlag.BIG: big,
            CPUMaskFlag.PRIMARY: primary,
        }
        return _mask_cache


def cpu_mask_set(flag: CPUMaskFlag) -> CpuSet:
    """reference: BandCPUMaskGetSet (band/device/cpu.cc:392-409)."""
    return CpuSet(_masks()[flag].cpus)


def parse_cpu_mask(spec: str) -> Optional[CpuSet]:
    """Parse a config mask: a flag name ("ALL"/"BIG"/...) or an explicit
    core list ("0,2-3").  Returns None for empty/unknown specs."""
    s = spec.strip().lower()
    if not s:
        return None
    try:
        return cpu_mask_set(CPUMaskFlag(s))
    except ValueError:
        pass
    cpus = set()
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, _, hi = part.partition("-")
            try:
                cpus.update(range(int(lo), int(hi) + 1))
            except ValueError:
                return None
        else:
            try:
                cpus.add(int(part))
            except ValueError:
                return None
    return CpuSet(cpus) if cpus else None


def set_thread_affinity(cpu_set: CpuSet, tid: int = 0) -> bool:
    """Pin a thread (0 = caller) to a core set; False when the set is
    empty or the platform refuses (reference: SetCPUThreadAffinity —
    and its cpu_test.cc semantics: empty set must fail)."""
    if cpu_set.num_enabled() == 0:
        return False
    try:
        os.sched_setaffinity(tid, cpu_set.cpus)
        return True
    except (AttributeError, OSError):
        return False


def get_thread_affinity(tid: int = 0) -> CpuSet:
    """reference: GetCPUThreadAffinity."""
    try:
        return CpuSet(os.sched_getaffinity(tid))
    except (AttributeError, OSError):
        return CpuSet()


def resolve_configured_mask(spec: str) -> Optional[CpuSet]:
    """Config-level resolution: unknown/empty → None (no pinning);
    a flag that resolves to an empty cluster on this host (e.g. PRIMARY
    on a homogeneous server) falls back to ALL so reference mobile
    configs run unmodified."""
    mask = parse_cpu_mask(spec)
    if mask is None:
        return None
    if mask.num_enabled() == 0:
        return cpu_mask_set(CPUMaskFlag.ALL)
    return mask
