"""Open loop of periodic streams: ``streams`` streams at ``fps`` frames a
second, stream s starting at its phase.  The phases are a fixed set
(``phases_ms``, one per stream, the same in every run); the seed deals
them to the streams and picks each stream's pool inputs, so every seed
sends the same arrivals with other frames.  Each request is sent when
due, whatever the answers; how late the sender ran is the send time
less the due time."""

from __future__ import annotations

import heapq
import time


def run(client, traffic, config, clock, rng) -> None:
    fps = float(traffic["fps"])
    streams = int(traffic["streams"])
    phases = [float(p) / 1000.0 for p in traffic["phases_ms"][:streams]]
    if len(phases) != streams:
        raise ValueError("the traffic needs one phase per stream")
    phases = [phases[i] for i in rng.permutation(streams)]
    pool = len(client.pool)
    offsets = rng.integers(0, pool, size=streams).tolist()
    period = 1.0 / fps
    due = [(clock.start + p, s, 0) for s, p in enumerate(phases)]
    heapq.heapify(due)
    while due:
        t, s, k = heapq.heappop(due)
        if t >= clock.t1:
            continue
        delay = t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        client.send([(offsets[s] + k) % pool], t)
        heapq.heappush(due, (clock.start + phases[s] + (k + 1) * period,
                             s, k + 1))
