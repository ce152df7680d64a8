"""Finds the rate a configuration sustains under its periodic traffic:
serves the traffic at rising stream counts, one engine for all, and
prints one JSON line per count (offered and answered frames a second,
p50 and p95 of due time to answer, the backlog at the close) and the
knee, the highest offered rate answered in full with no backlog left.

    python3 portbench/sweep.py --workload fsrcnn_x2_int8.video \\
        --streams 8,12,16,20,24 --seconds 5 --seed 7

Run on the card; a cell's stream count is set from the knee it prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--streams", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import band_tpu_torch as bt
    from portbench import harness, spec
    from portbench.client import Client
    from portbench.metrics._common import percentile

    if args.device == "cuda" and not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    c = spec.cell(ROOT, args.workload)
    config, traffic = c["config"], dict(c["traffic"])
    model_path = os.path.join(ROOT, config["model"])
    from portbench.reference.tflite import read_model

    ref_model = read_model(model_path)
    pool = harness.make_pool(args.seed, ref_model.tensors[
        ref_model.inputs[0]].shape, int(traffic["pool"]))
    loop = spec.loop(ROOT, traffic["loop"])
    engine = harness.make_engine(bt, config, args.device)
    knee = 0.0
    try:
        mid = engine.register_model(bt.Model.from_path(model_path))
        engine.wait_buckets_ready(timeout=1100)
        for n in [int(v) for v in args.streams.split(",")]:
            client = Client(engine, mid, pool, bt.JobStatus.SUCCESS)
            traffic["streams"] = n
            start = time.perf_counter()
            clock = harness.Clock(start, start + 1.0,
                                  start + 1.0 + args.seconds)
            rng = np.random.default_rng([args.seed, n])
            th = threading.Thread(target=loop.run, args=(
                client, traffic, config, clock, rng), daemon=True)
            th.start()
            th.join()
            backlog = client.outstanding()
            client.drain(clock.t1 + 60.0)
            client.close()
            window = [r for r in client.records.values()
                      if clock.t0 <= r.due < clock.t1]
            lat = [((r.done if r.ok else clock.t1 + 60.0) - r.due) * 1e3
                   for r in window]
            answered = sum(1 for r in client.records.values()
                           if r.ok and clock.t0 <= r.done < clock.t1)
            offered = len(window) / args.seconds
            row = dict(streams=n, offered_fps=offered,
                       answered_fps=answered / args.seconds,
                       p50_ms=percentile(lat, 0.5),
                       p95_ms=percentile(lat, 0.95),
                       failed=sum(1 for r in window if not r.ok),
                       backlog_at_close=backlog)
            print(json.dumps(row), flush=True)
            if (row["failed"] == 0 and answered >= 0.99 * len(window)
                    and backlog <= int(config["max_batch"]) * 2):
                knee = max(knee, offered)
            time.sleep(0.5)
    finally:
        engine.shutdown()
    print(json.dumps(dict(knee_fps=knee,
                          streams_at_four_fifths=round(0.8 * knee / float(
                              traffic["fps"])))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
