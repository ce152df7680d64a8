"""Multi-process runtime: torch.distributed bring-up, the global device
pool and host-spanning meshes.

The reference is strictly single-process (SURVEY §5.8).  Like band_tpu
(band_tpu/parallel/distributed.py) the port serves across processes in
two tiers: replicated engines behind a router (tools/router.py), and
ONE engine spanning processes, this module's tier.  Every process runs
the same engine from the same config; ``initialize()`` brings up
``torch.distributed`` (coordinator handshake over TCP), after which
``devices(kind)`` is the GLOBAL device list: every process's local
devices, process by process in rank order.  Mesh workers index it with
global ids (``WorkerSpec.device_ids``); the SPMD control plane
(parallel/spmd.py) replays the leader's launches on the other
processes.

Local devices of a process: its cards (``local_device_ids``, else every
visible card) for GPU workers, and for CPU workers a pool of
``CPU_VIRTUAL_DEVICES`` virtual devices, all ``torch.device("cpu")``
(``local_device_ids`` picks among them too).  Two processes on one card
each own ``cuda:0`` as their local device 0: together they form the
same two-device global mesh that two hosts with one card each form.

Backends are a rule, not a knob: the default group is gloo (the control
collectives, the device exchange, CPU workers).  A card group is NCCL
only where every rank has cards of its own (device UUIDs exchanged over
the gloo group at bring-up); where two ranks share a card (NCCL refuses
two ranks on one device) it is gloo too.  Gloo has no all_gather on CUDA
tensors, so a card collective over gloo is staged through pinned host
buffers: ``all_gather`` and ``broadcast`` of a CUDA tensor over a gloo
group copy it to the host and back.  Every collective is bounded by the
group's timeout (``COLLECTIVE_TIMEOUT_S``): a launch order that differs
between processes raises, never hangs.

Configuration: the ``distributed`` block of the runtime JSON
(coordinator_address / num_processes / process_id / local_device_ids),
or, with ``auto_detect``, the BAND_TPU_* environment (``from_env``).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DistributedConfig
from ..errors import ConfigError
from ..tracing.logger import log_info

# The CPU pool: this many virtual devices, all torch.device("cpu"), so a
# CPU mesh worker is testable without cards (band_tpu's tests force 8
# XLA host devices, tests/conftest.py).
CPU_VIRTUAL_DEVICES = 8
# every collective of a group waits at most this long for its peers
COLLECTIVE_TIMEOUT_S = 300


@dataclass(frozen=True)
class GlobalDevice:
    """One entry of the global device pool: a process's local device."""

    process_index: int
    device: torch.device  # as that process names it
    uuid: str = ""


class _Cluster:
    def __init__(self, rank: int, world: int,
                 pools: Dict[str, List[GlobalDevice]], card_backend: str):
        self.rank = rank
        self.world = world
        self.pools = pools
        self.card_backend = card_backend


_cluster: Optional[_Cluster] = None
_local_ids: Optional[Tuple[int, ...]] = None


def process_index() -> int:
    return _cluster.rank if _cluster is not None else 0


def process_count() -> int:
    return _cluster.world if _cluster is not None else 1


def card_backend() -> str:
    """The backend of card groups: "nccl" where every rank has cards of
    its own, else "gloo" (staged through host buffers)."""
    return _cluster.card_backend if _cluster is not None else "gloo"


def local_devices(kind: str) -> List[torch.device]:
    """This process's devices of ``kind`` ("cpu" or "cuda")."""
    if kind == "cpu":
        n = CPU_VIRTUAL_DEVICES
        ids = _local_ids if _local_ids is not None else range(n)
        for i in ids:
            if not 0 <= i < n:
                raise ConfigError(f"local CPU device {i} outside the "
                                  f"{n} virtual devices")
        return [torch.device("cpu") for _ in ids]
    if not torch.cuda.is_available():
        return []
    n = torch.cuda.device_count()
    ids = _local_ids if _local_ids is not None else range(n)
    for i in ids:
        if not 0 <= i < n:
            raise ConfigError(f"local card {i} is not visible ({n} cards)")
    return [torch.device("cuda", i) for i in ids]


def _card_uuid(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{props.name}-{getattr(props, 'pci_bus_id', device.index)}"


def _local_pool(kind: str, rank: int) -> List[GlobalDevice]:
    return [GlobalDevice(rank, d, _card_uuid(d) if d.type == "cuda" else "")
            for d in local_devices(kind)]


def devices(kind: str) -> List[GlobalDevice]:
    """The global pool of ``kind``: every process's local devices, in
    rank order (one process: this process's)."""
    if _cluster is None:
        return _local_pool(kind, 0)
    return list(_cluster.pools[kind])


_global_pool = devices


def initialize(cfg: Optional[DistributedConfig] = None) -> bool:
    """Bring up torch.distributed once per process; returns True when a
    multi-process runtime is active after the call."""
    global _cluster, _local_ids
    cfg = cfg or DistributedConfig()
    if not cfg.enabled or _cluster is not None:
        return process_count() > 1
    if not cfg.coordinator_address:
        env = from_env()  # auto_detect: the launcher's environment
        cfg = DistributedConfig(
            coordinator_address=env.coordinator_address,
            num_processes=env.num_processes, process_id=env.process_id,
            local_device_ids=cfg.local_device_ids,
            control_port=cfg.control_port)
    if (not cfg.coordinator_address or cfg.num_processes < 1
            or not 0 <= cfg.process_id < cfg.num_processes):
        raise ConfigError(
            "distributed serving needs coordinator_address, num_processes "
            f"and process_id (got {cfg.coordinator_address!r}, "
            f"{cfg.num_processes}, {cfg.process_id})")
    import torch.distributed as dist

    _local_ids = (tuple(int(i) for i in cfg.local_device_ids)
                  if cfg.local_device_ids is not None else None)
    rank, world = cfg.process_id, cfg.num_processes
    host = cfg.coordinator_address.rpartition(":")[0]
    if host in ("localhost", "127.0.0.1") and "GLOO_SOCKET_IFNAME" not in \
            os.environ:
        # a cluster on one host: gloo's pairs over the loopback interface,
        # whatever the host name resolves to
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group(
        "gloo", init_method=f"tcp://{cfg.coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mine = {kind: _local_pool(kind, rank) for kind in ("cpu", "cuda")}
    every: List[Dict] = [None] * world
    dist.all_gather_object(every, mine)
    pools = {kind: [d for p in every for d in p[kind]]
             for kind in ("cpu", "cuda")}
    # NCCL only where every rank has cards and no card serves two ranks
    uuids = [[d.uuid for d in p["cuda"]] for p in every]
    flat = [u for us in uuids for u in us]
    own = all(uuids) and len(set(flat)) == len(flat)
    _cluster = _Cluster(rank, world, pools, "nccl" if own else "gloo")
    if rank == 0:
        log_info("distributed: %d processes, %d cards; card collectives "
                 "over %s%s", world, len(flat), _cluster.card_backend,
                 "" if own else " (a card serves two ranks, or a rank has "
                 "none: staged through pinned host buffers)")
    return world > 1


def from_env() -> DistributedConfig:
    """DistributedConfig from BAND_TPU_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID environment variables (per-host launcher convenience)."""
    return DistributedConfig(
        coordinator_address=os.environ.get("BAND_TPU_COORDINATOR", ""),
        num_processes=int(os.environ.get("BAND_TPU_NUM_PROCESSES", "-1")),
        process_id=int(os.environ.get("BAND_TPU_PROCESS_ID", "-1")),
    )


def global_mesh(dp: int = -1, tp: int = -1,
                devices: Optional[Sequence[GlobalDevice]] = None):
    """(dp, tp) mesh over the global device list (default: every
    process's cards, else their CPU devices), laid out so "tp" stays
    within a process and "dp" strides across processes.

    dp/tp of -1 auto-size: tp = devices-per-process, dp = total/tp.  The
    device array is ordered process-major so each tp row is one
    process's devices."""
    from .mesh import Mesh

    pool = list(devices) if devices is not None else (
        _global_pool("cuda") or _global_pool("cpu"))
    by_proc: Dict[int, List[GlobalDevice]] = {}
    for d in pool:
        by_proc.setdefault(d.process_index, []).append(d)
    per_proc = min(len(v) for v in by_proc.values())
    if tp < 0:
        tp = per_proc
    if dp < 0:
        dp = len(pool) // tp
    if dp * tp > len(pool):
        raise ValueError(
            f"mesh {dp}x{tp} needs {dp * tp} devices, have {len(pool)}")
    ordered = [d for p in sorted(by_proc) for d in by_proc[p]][: dp * tp]
    return Mesh([d.device for d in ordered], dp, tp,
                [d.process_index for d in ordered])


def process_span(devices: Sequence[GlobalDevice]) -> int:
    """Number of distinct processes a device group touches: the
    scheduler's signal that a hop crosses processes (DCN)."""
    return len({d.process_index for d in devices})


# ----------------------------------------------------------------------
# groups and collectives
# ----------------------------------------------------------------------
def group(ranks: Sequence[int], cards: bool):
    """A process group over ``ranks`` for a mesh's collectives, new on
    every call: each mesh gets groups of its own, so two workers'
    collectives never interleave on one group.  COLLECTIVE: every
    process of the cluster must call it, in the same order (engines
    build their meshes worker by worker from the same config)."""
    import torch.distributed as dist

    backend = card_backend() if cards else "gloo"
    return dist.new_group(
        sorted(ranks), backend=backend,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _staged(t: torch.Tensor, g) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(g) != "nccl"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)  # waits for the producing kernels
    return host


def all_gather(t: torch.Tensor, g) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in the group's rank order, on
    ``t``'s device.  A CUDA tensor over a gloo group is staged through
    pinned host memory."""
    import torch.distributed as dist

    n = dist.get_world_size(g)
    if _staged(t, g):
        host = _to_host(t.contiguous())
        outs = [torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                for _ in range(n)]
        dist.all_gather(outs, host, group=g)
        return [o.to(t.device, non_blocking=True) for o in outs]
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(outs, t, group=g)
    return outs


def broadcast(t: torch.Tensor, src: int, g) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``g`` (the others
    pass a tensor of the same shape and type to fill); returns it on
    ``t``'s device."""
    import torch.distributed as dist

    if _staged(t, g):
        host = _to_host(t.contiguous())
        dist.broadcast(host, src, group=g)
        return host.to(t.device, non_blocking=True)
    t = t.contiguous()
    dist.broadcast(t, src, group=g)
    return t


def barrier() -> None:
    """Every process of the cluster reaches this point (the default gloo
    group, bounded by its timeout)."""
    if _cluster is None:
        return
    import torch.distributed as dist

    dist.barrier()


def agree(values: Sequence[int]) -> np.ndarray:
    """Process 0's int64 ``values`` on every process."""
    t = torch.as_tensor(np.asarray(values, np.int64))
    if _cluster is not None:
        import torch.distributed as dist

        dist.broadcast(t, 0)
    return t.numpy()
