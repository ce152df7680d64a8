"""Shared arithmetic of the readers."""

from __future__ import annotations

import math
from typing import List, Optional

from portbench.work import CONV_FAMILY


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile (0 < q <= 1): the smallest value
    with at least q of the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]


def latencies_ms(run) -> List[float]:
    """Each request's time from its due time to its answer on the host;
    a failed or missing answer counts as arriving when the wait for it
    ended, so it lies above every answer that came."""
    end = run.clock.t1 + 60.0
    return [((r.done if r.ok else max(end, r.done or end)) - r.due) * 1e3
            for r in run.window]


def is_conv(graph_op: str) -> bool:
    return graph_op.startswith("op") and graph_op.split("_", 1)[1] in \
        CONV_FAMILY
