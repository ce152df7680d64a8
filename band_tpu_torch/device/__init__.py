"""Host device/OS layer (reference: band/device/).

CPU topology + thread affinity for the host threads that feed GPU
devices (dispatch threads, planner thread), plus sysfs helpers shared
with the resource monitor.
"""

from .cpu import (  # noqa: F401
    CPUMaskFlag,
    CpuSet,
    cpu_count,
    cpu_mask_set,
    get_thread_affinity,
    parse_cpu_mask,
    set_thread_affinity,
)
