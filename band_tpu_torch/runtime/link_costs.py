"""Single-source transfer-cost model for the scheduler seam.

Every latency-aware scheduler prices cross-worker hops through
``Engine.get_transfer_cost_us`` (Python DP) or the native decision core
(``runtime/native/plan_core.cc``).  This table is the single source
both consume — injectable for tests, overridable from config JSON, and
measurable on the live transport at engine init.

The reference never costs its transport (an in-process memcpy,
band/engine.cc:1247-1365); here a hop may cross PCIe between the host
and a card or a link between cards, and mispriced links flip HEFT, SEL
and LSF decisions, so the constants are measured where it matters.

Link classes, as in band_tpu (the table and its config keys are the
same): ``h2d`` host <-> card, ``host`` host memcpy, ``ici`` card <->
card, ``dcn`` across processes (``measure_dcn``, on a live
torch.distributed cluster).  Cost model per link class:
``fixed_us + nbytes // bytes_per_us``.

Counterpart: band_tpu/runtime/link_costs.py; ``measure`` times torch
copies (``Tensor.to`` from pageable host memory, the copy the serving
path makes) with ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# link-class indices into the (4, 2) table — keep in sync with the
# switch in plan_core.cc:xfer_cost
H2D, HOST, ICI, DCN = 0, 1, 2, 3
_NAMES = {"h2d": H2D, "host": HOST, "ici": ICI, "dcn": DCN}

# band_tpu's defaults, kept so the two packages price hops alike until
# a table is configured or measured:
#   H2D  ~10 GB/s + launch overhead
#   HOST memcpy ~50 GB/s
#   ICI  card <-> card ~45 GB/s + launch overhead
#   DCN  cross-host ~3 GB/s + connection latency
DEFAULTS = np.array(
    [[30, 10_000], [1, 50_000], [5, 45_000], [50, 3_000]], dtype=np.int64
)


class LinkCostTable:
    """(4, 2) int64 [link_class][fixed_us, bytes_per_us].

    The array identity is stable for the table's lifetime: the native
    planner reads it by pointer, so updates must write through
    ``table[:]``, never rebind."""

    def __init__(self, table: Optional[np.ndarray] = None):
        self.table = np.array(
            DEFAULTS if table is None else table, dtype=np.int64
        ).reshape(4, 2)

    def cost_us(self, link: int, nbytes: int) -> int:
        fixed, per = self.table[link]
        return int(fixed) + int(nbytes) // max(int(per), 1)

    def set(self, link: int, fixed_us: int, bytes_per_us: int) -> None:
        self.table[link, 0] = max(int(fixed_us), 0)
        self.table[link, 1] = max(int(bytes_per_us), 1)

    def update_from_dict(self, d: Dict) -> None:
        """{"h2d": [fixed_us, bytes_per_us], "ici": ..., ...} (config
        JSON ``link_costs`` block); unknown keys raise."""
        for name, pair in d.items():
            link = _NAMES.get(name.lower())
            if link is None:
                raise ValueError(f"unknown link class {name!r}")
            fixed, per = pair
            self.set(link, fixed, per)

    def to_dict(self) -> Dict:
        return {
            name: [int(self.table[i, 0]), int(self.table[i, 1])]
            for name, i in _NAMES.items()
        }

    def __repr__(self) -> str:
        return f"LinkCostTable({self.to_dict()})"


def _time_once(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e6  # µs


def _best_of(fn, n: int = 3) -> float:
    return min(_time_once(fn) for _ in range(n))


def _fit(small_us: float, big_us: float, small_b: int, big_b: int):
    """(fixed_us, bytes_per_us) from a two-point probe; degenerate
    timings (big no slower than small) collapse to pure fixed cost."""
    fixed = max(small_us, 1.0)
    d_us = big_us - small_us
    if d_us <= 0:
        return int(fixed), 1 << 40  # bandwidth unobservable: ~free per byte
    return int(fixed), max(int((big_b - small_b) / d_us), 1)


def topology_hash() -> str:
    """Key for persisted probed tables: probing is only valid for the
    same process count, card count and card model."""
    from ..parallel.distributed import process_count

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    name = torch.cuda.get_device_name(0) if n else "cpu"
    return f"p{process_count()}-d{n}-{name.replace(' ', '_')}"


def save_table(table: LinkCostTable, path: str) -> None:
    """Persist a probed table keyed by topology hash (the link-cost
    analogue of the latency profile DB, reference:
    band/latency_estimator.cc:185-289)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"hash": topology_hash(), "links": table.to_dict()}, f,
                  indent=1)


def load_table(path: str, table: LinkCostTable) -> bool:
    """Load a persisted probed table; stale topology hashes are
    ignored.  Returns True when the table was updated."""
    if not os.path.exists(path):
        return False
    with open(path) as f:
        payload = json.load(f)
    if payload.get("hash") != topology_hash():
        return False
    table.update_from_dict(payload.get("links", {}))
    return True


def measure(
    devices: Sequence[torch.device], table: Optional[LinkCostTable] = None,
    small_bytes: int = 1 << 14, big_bytes: int = 1 << 22,
) -> LinkCostTable:
    """Probe host-memcpy, host -> card and (when the workers use >= 2
    distinct cards) card -> card link costs and write them into
    `table`.

    Two transfer sizes separate fixed launch overhead from per-byte
    cost.  Each probe copies a fresh host tensor from pageable memory
    with ``Tensor.to`` (what ``Engine.try_copy_input_tensors`` does on
    a hop) and waits with ``torch.cuda.synchronize``, so the numbers
    include the round trip the schedulers will actually pay.  Card to
    card is probed where two or more cards are visible to the workers
    (a mesh's included); DCN by ``measure_dcn``."""
    table = table or LinkCostTable()
    small = np.ones(small_bytes, np.uint8)
    big = np.ones(big_bytes, np.uint8)

    # host memcpy
    t_s = _best_of(lambda: small.copy())
    t_b = _best_of(lambda: big.copy())
    table.set(HOST, *_fit(t_s, t_b, small_bytes, big_bytes))

    cards = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d not in cards:
            cards.append(d)
    if cards:
        dev = cards[0]

        def h2d(arr):
            torch.from_numpy(arr).to(dev)
            torch.cuda.synchronize(dev)

        h2d(small)  # warm the transfer path once
        t_s = _best_of(lambda: h2d(small))
        t_b = _best_of(lambda: h2d(big))
        table.set(H2D, *_fit(t_s, t_b, small_bytes, big_bytes))
    if len(cards) >= 2:
        src = torch.from_numpy(big).to(cards[0])
        src_s = torch.from_numpy(small).to(cards[0])
        torch.cuda.synchronize(cards[0])

        def d2d(t):
            t.to(cards[1])
            torch.cuda.synchronize(cards[1])

        d2d(src_s)
        t_s = _best_of(lambda: d2d(src_s))
        t_b = _best_of(lambda: d2d(src))
        table.set(ICI, *_fit(t_s, t_b, small_bytes, big_bytes))
    return table


def measure_dcn(
    table: Optional[LinkCostTable] = None,
    small_bytes: int = 1 << 14, big_bytes: int = 1 << 22,
) -> LinkCostTable:
    """Probe the cross-process (DCN) payload path on a live
    torch.distributed cluster and write the fit into `table`.  Every
    process must call this at the same point: the probe is a broadcast
    from process 0 over the default (gloo) group, the path of the
    cluster's host collectives, and process 0's fit is then broadcast so
    that every process writes the same values
    (band_tpu/runtime/link_costs.py:100-133)."""
    from ..parallel import distributed as dist

    table = table or LinkCostTable()
    if dist.process_count() < 2:
        return table
    import torch.distributed as tdist

    small = torch.ones(small_bytes, dtype=torch.uint8)
    big = torch.ones(big_bytes, dtype=torch.uint8)

    def bcast(t):
        tdist.broadcast(t, 0)

    bcast(small)  # warm the path (the first collective pays setup)
    t_s = _best_of(lambda: bcast(small))
    t_b = _best_of(lambda: bcast(big))
    fixed, per = dist.agree(_fit(t_s, t_b, small_bytes, big_bytes))
    table.set(DCN, int(fixed), int(per))
    return table
