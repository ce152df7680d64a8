"""Closed loop: ``in_flight`` requests in flight until the window closes,
refilled answer by answer: each answer on the host sends one new
request at once, as a client does that works through a backlog.  The
count is the traffic's own and does not follow the engine's window
size, so how the planner forms windows from such a backlog is part of
what a run measures.  The pool inputs go round in an order drawn from
the seed."""

from __future__ import annotations

import itertools
import time


def run(client, traffic, config, clock, rng) -> None:
    order = itertools.cycle(rng.permutation(len(client.pool)).tolist())

    def on_answer(_rec) -> None:
        now = time.perf_counter()
        if now < clock.t1:
            client.send([next(order)], now)

    client.on_answer = on_answer
    n = int(traffic["in_flight"])
    client.send([next(order) for _ in range(n)], time.perf_counter())
    while time.perf_counter() < clock.t1:
        time.sleep(min(0.05, max(clock.t1 - time.perf_counter(), 0.0)))
    client.on_answer = None
