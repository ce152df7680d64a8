"""ResourceMonitor: background polling of host and card health metrics.

A copy of band_tpu/monitor/resource_monitor.py (itself after the
reference's sysfs poller, band/resource_monitor.{h,cc}: thermal zones,
cpufreq and devfreq into double-buffered status maps with update
callbacks): the sysfs sources, /proc loadavg and meminfo, the
double-buffered snapshots, the callbacks and the JSON log are the same.
Two sources differ:

 * ``nvidia_smi_metrics`` takes the place of band_tpu's libtpu duty
   cycle: one ``nvidia-smi`` query per poll gives each card's
   utilization, SM clock, temperature and power draw, under the key
   suffixes the engine's throttle policy reads (``_duty_cycle_pct``,
   ``_clock_hz``);
 * the card memory of each monitored CUDA device comes from PyTorch:
   ``dev<index>_hbm_in_use_bytes`` is this process's own allocations
   (``torch.cuda.memory_allocated``, as PJRT's ``bytes_in_use`` is the
   process's), ``dev<index>_hbm_limit_bytes`` the card's total memory
   (``torch.cuda.mem_get_info``)."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

StatusMap = Dict[str, float]
UpdateCallback = Callable[[StatusMap], None]
MetricsSource = Callable[[], StatusMap]

NVIDIA_SMI_QUERY = (
    "index,utilization.gpu,clocks.sm,temperature.gpu,power.draw"
)


def _read_float(path: str) -> Optional[float]:
    try:
        with open(path) as f:
            return float(f.read().strip())
    except (OSError, ValueError):
        return None


def devfreq_metrics() -> StatusMap:
    """Accelerator clocks from /sys/class/devfreq (the reference's
    GPU/NPU frequency polling, band/resource_monitor.cc:189,533)."""
    out: StatusMap = {}
    for p in sorted(glob.glob("/sys/class/devfreq/*/cur_freq")):
        name = p.split("/")[-2]
        v = _read_float(p)
        if v is not None:
            out[f"devfreq_{name}_hz"] = v
    return out


def parse_nvidia_smi(text: str) -> StatusMap:
    """Metrics from ``nvidia-smi --query-gpu=index,utilization.gpu,
    clocks.sm,temperature.gpu,power.draw --format=csv,noheader,nounits``
    output: per card ``gpu<i>_duty_cycle_pct`` (%), ``gpu<i>_clock_hz``
    (the SM clock, reported in MHz), ``gpu<i>_temp_mC`` (reported in °C)
    and ``gpu<i>_power_w``.  A field the card does not report
    (``[N/A]``, ``N/A``, ``[Not Supported]``) or cannot parse is left
    out; a line without a card index is skipped."""
    out: StatusMap = {}
    scales = (("duty_cycle_pct", 1.0), ("clock_hz", 1e6),
              ("temp_mC", 1e3), ("power_w", 1.0))
    for line in text.splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) != 1 + len(scales):
            continue
        try:
            idx = int(fields[0])
        except ValueError:
            continue
        for raw, (suffix, scale) in zip(fields[1:], scales):
            try:
                out[f"gpu{idx}_{suffix}"] = float(raw) * scale
            except ValueError:
                continue
    return out


def nvidia_smi_metrics() -> StatusMap:
    """Card utilization, SM clock, temperature and power draw from one
    nvidia-smi query ({} where nvidia-smi is absent or fails)."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={NVIDIA_SMI_QUERY}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if proc.returncode != 0:
        return {}
    return parse_nvidia_smi(proc.stdout)


def default_device_metrics_sources() -> List[MetricsSource]:
    return [devfreq_metrics, nvidia_smi_metrics]


class ResourceMonitor:
    def __init__(
        self,
        interval_ms: int = 1000,
        log_path: str = "",
        devices: Optional[list] = None,
        metrics_sources: Optional[List[MetricsSource]] = None,
    ):
        self._interval = interval_ms / 1000.0
        self._log_path = log_path
        # torch.device objects whose card memory is read every poll
        self._devices = devices
        # pluggable device-metric sources (devfreq clocks, nvidia-smi,
        # test fakes); each returns a {metric: value} map merged into
        # every snapshot
        self._metrics_sources = (
            metrics_sources
            if metrics_sources is not None
            else default_device_metrics_sources()
        )
        self._callbacks: List[UpdateCallback] = []
        # double-buffered snapshots with head swap (reference:
        # resource_monitor.h:129-133)
        self._buffers: List[StatusMap] = [{}, {}]
        self._head = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thermal_zones = sorted(
            glob.glob("/sys/class/thermal/thermal_zone*/temp")
        )
        self._cpufreq = sorted(
            glob.glob("/sys/devices/system/cpu/cpu*/cpufreq/scaling_cur_freq")
        )

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return  # already polling; no duplicate threads
        self._stop.clear()  # restartable after stop()
        self._thread = threading.Thread(
            target=self._loop, name="band-resource-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def add_callback(self, cb: UpdateCallback) -> None:
        self._callbacks.append(cb)

    def status(self) -> StatusMap:
        """Latest snapshot (lock-free read of the stable buffer)."""
        return dict(self._buffers[self._head])

    # ------------------------------------------------------------------
    def _card_memory(self, out: StatusMap) -> None:
        import torch

        for d in self._devices or ():
            if d.type != "cuda":
                continue
            idx = d.index if d.index is not None else 0
            try:
                out[f"dev{idx}_hbm_in_use_bytes"] = float(
                    torch.cuda.memory_allocated(idx))
                out[f"dev{idx}_hbm_limit_bytes"] = float(
                    torch.cuda.mem_get_info(idx)[1])
            except RuntimeError:
                continue

    def _collect(self) -> StatusMap:
        out: StatusMap = {"ts": time.time()}
        for p in self._thermal_zones:
            # label by the real zone number (lexicographic glob order
            # would misnumber zone10 vs zone2 on hosts with >9 zones)
            zone = p.split("/")[-2][len("thermal_zone"):]
            v = _read_float(p)
            if v is not None:
                out[f"thermal_zone{zone}_mC"] = v
        for p in self._cpufreq:
            cpu = p.split("/")[5]
            v = _read_float(p)
            if v is not None:
                out[f"{cpu}_khz"] = v
        try:
            load1, load5, load15 = os.getloadavg()
            out["loadavg_1m"] = load1
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith(("MemAvailable", "MemTotal")):
                        k, v = line.split(":")
                        out[k.strip().lower() + "_kb"] = float(
                            v.strip().split()[0]
                        )
        except OSError:
            pass
        self._card_memory(out)
        for source in self._metrics_sources:
            try:
                out.update(source())
            except Exception:
                continue
        return out

    def _loop(self) -> None:
        log_f = open(self._log_path, "a") if self._log_path else None
        try:
            while not self._stop.wait(self._interval):
                snap = self._collect()
                back = 1 - self._head
                self._buffers[back] = snap
                self._head = back  # atomic head swap
                for cb in self._callbacks:
                    try:
                        cb(snap)
                    except Exception:
                        pass
                if log_f:
                    log_f.write(json.dumps(snap) + "\n")
                    log_f.flush()
        finally:
            if log_f:
                log_f.close()
