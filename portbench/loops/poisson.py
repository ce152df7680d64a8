"""Open loop of Poisson arrivals at ``rate`` requests a second.  The gaps
are a fixed set, drawn once from ``arrival_seed``; the run's seed orders
them and picks the pool inputs, so every seed sends the same set of gaps
in another order.  Each request is sent when due, whatever the answers."""

from __future__ import annotations

import time

import numpy as np


def run(client, traffic, config, clock, rng) -> None:
    rate = float(traffic["rate"])
    span = clock.t1 - clock.start
    count = int(rate * span * 1.5) + 16
    gaps = np.random.default_rng(int(traffic["arrival_seed"])).exponential(
        1.0 / rate, size=count)
    gaps = gaps[rng.permutation(count)]
    picks = rng.integers(0, len(client.pool), size=count).tolist()
    t = clock.start
    for gap, pick in zip(gaps.tolist(), picks):
        t += gap
        if t >= clock.t1:
            break
        delay = t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        client.send([pick], t)
