"""Per-subgraph latency database: profile-once + EMA online updates +
JSON persistence keyed by a config hash.

Reference: band/latency_estimator.{h,cc} — {profiled, moving_averaged}
per SubgraphKey (:43-46), EMA update a*new + (1-a)*old (:32-45), offline
profile load/dump keyed by config hash (:185-289).

Two deliberate departures from the reference (TPU-serving necessities):

* **Batch buckets.** Continuous batching runs B stacked requests as one
  device program whose cost scales sublinearly but NOT flatly with B
  (measured: mobilenet b8 ~5x b1, docs/performance.md).  The reference
  prices every dispatch at one batch-1 latency (it never batches); here
  each key keeps one record per power-of-two bucket, and
  ``get_expected(key, batch)`` interpolates between profiled buckets so
  worker waiting times, HEFT stacking and SLO checks price a window at
  its true bucket cost.
* **Noise-robust updates.** The reference's plain EMA
  (latency_estimator.cc:32-45) lets one transport spike poison the cost
  DB every scheduler reads.  Profiling takes the median of the timed
  runs, and online EMA updates clip each sample to
  [old/outlier_clip, old*outlier_clip] before blending, so a 5x latency
  spike moves the estimate by at most alpha*(clip-1).
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..common import SubgraphKey, bucket_of


@dataclass
class LatencyRecord:
    profiled: int = 0  # µs, from isolated profiling runs
    moving_averaged: int = 0  # µs, EMA over real invocations

    def expected(self) -> int:
        return self.moving_averaged or self.profiled or -1


def _key_str(key: SubgraphKey) -> str:
    units = ",".join(str(u) for u in sorted(key.unit_indices))
    return f"{key.model_id}:{key.worker_id}:{units}"


class LatencyEstimator:
    def __init__(
        self,
        smoothing_factor: float = 0.1,
        num_warmups: int = 1,
        num_runs: int = 1,
        profile_data_path: str = "",
        config_hash: str = "",
        outlier_clip: float = 2.5,
    ):
        self._alpha = smoothing_factor
        self._warmups = num_warmups
        self._runs = num_runs
        self._path = profile_data_path
        self._hash = config_hash
        # outlier_clip <= 1 disables clipping (plain reference EMA)
        self._clip = outlier_clip
        # key -> {bucket: record}; bucket 1 is the reference-equivalent
        # single-request record
        self._db: Dict[SubgraphKey, Dict[int, LatencyRecord]] = {}
        self._lock = threading.Lock()
        # write-through slots into the native planner's flat expected-
        # latency arrays (runtime/native.PlanTables), so scheduler-time
        # DP calls marshal nothing per key.  Slots mirror the bucket-1
        # expected latency (the DP prices one job's remaining path).
        self._slots: Dict[SubgraphKey, list] = {}
        if self._path:
            self.load_profile(self._path)

    # ------------------------------------------------------------------
    def bind_slot(self, key: SubgraphKey, arr, idx: int) -> None:
        """Mirror this key's bucket-1 expected latency into arr[idx] on
        every update (arr is a shared int64 numpy array)."""
        with self._lock:
            self._slots.setdefault(key, []).append((arr, idx))
            rec = self._db.get(key, {}).get(1)
            arr[idx] = rec.expected() if rec else -1

    def _write_through(self, key: SubgraphKey, rec: LatencyRecord) -> None:
        for arr, idx in self._slots.get(key, ()):
            arr[idx] = rec.expected()

    def unbind_model(self, model_id: int) -> None:
        """Drop write-through slots for an unregistered model (the
        latency records themselves persist, like the reference's profile
        DB outliving any one registration)."""
        with self._lock:
            for key in [k for k in self._slots if k.model_id == model_id]:
                del self._slots[key]

    def _rec(self, key: SubgraphKey, bucket: int) -> LatencyRecord:
        return self._db.setdefault(key, {}).setdefault(
            bucket, LatencyRecord()
        )

    # ------------------------------------------------------------------
    def profile(
        self, key: SubgraphKey, invoke: Callable[[], None], batch: int = 1
    ) -> int:
        """Measure `invoke` (warmups + timed runs) and record the result
        (reference: latency_estimator.cc:92-116).  Uses the median of
        the timed runs, not the mean, so one transport spike in the
        profiling window doesn't seed a bad estimate."""
        bucket = bucket_of(batch)
        for _ in range(self._warmups):
            invoke()
        samples = []
        for _ in range(self._runs):
            t0 = time.perf_counter_ns()
            invoke()
            samples.append((time.perf_counter_ns() - t0) // 1000)
        elapsed_us = int(statistics.median(samples))
        with self._lock:
            rec = self._rec(key, bucket)
            rec.profiled = elapsed_us
            rec.moving_averaged = elapsed_us
            if bucket == 1:
                self._write_through(key, rec)
        return elapsed_us

    def update(
        self, key: SubgraphKey, latency_us: int, batch: int = 1
    ) -> None:
        """EMA update from a real invocation (reference: :32-45), with
        the sample clipped to within outlier_clip x the current estimate
        so transport phase changes can't poison the DB."""
        bucket = bucket_of(batch)
        with self._lock:
            rec = self._rec(key, bucket)
            if rec.moving_averaged == 0:
                rec.moving_averaged = int(latency_us)
            else:
                sample = float(latency_us)
                if self._clip > 1.0:
                    lo = rec.moving_averaged / self._clip
                    hi = rec.moving_averaged * self._clip
                    sample = min(max(sample, lo), hi)
                rec.moving_averaged = int(
                    self._alpha * sample
                    + (1.0 - self._alpha) * rec.moving_averaged
                )
            if bucket == 1:
                self._write_through(key, rec)

    def override(
        self, key: SubgraphKey, latency_us: int, batch: int = 1
    ) -> None:
        """Pin a key's expected latency exactly (cost-model injection
        for tests and what-if scheduling analyses)."""
        bucket = bucket_of(batch)
        with self._lock:
            rec = self._rec(key, bucket)
            rec.profiled = int(latency_us)
            rec.moving_averaged = int(latency_us)
            if bucket == 1:
                self._write_through(key, rec)

    def set_profiled(
        self, key: SubgraphKey, latency_us: int, batch: int = 1
    ) -> None:
        bucket = bucket_of(batch)
        with self._lock:
            rec = self._rec(key, bucket)
            rec.profiled = int(latency_us)
            if rec.moving_averaged == 0:
                rec.moving_averaged = int(latency_us)
            if bucket == 1:
                self._write_through(key, rec)

    # ------------------------------------------------------------------
    def get_profiled(self, key: SubgraphKey, batch: int = 1) -> int:
        rec = self._db.get(key, {}).get(bucket_of(batch))
        return rec.profiled if rec else -1

    def get_expected(self, key: SubgraphKey, batch: int = 1) -> int:
        """Expected µs of one dispatch of `batch` stacked requests.

        Exact bucket if recorded; otherwise linear interpolation in
        batch between the nearest recorded buckets (the verdict-
        prescribed b1/b-max two-point model), linear extrapolation by
        average per-request cost above the largest recorded bucket, and
        the smallest recorded bucket's cost below it (batched programs
        never get cheaper than their smallest measured bucket)."""
        buckets = self._db.get(key)
        if not buckets:
            return -1
        bucket = bucket_of(batch)
        rec = buckets.get(bucket)
        if rec is not None and rec.expected() > 0:
            return rec.expected()
        known = sorted(
            (b, r.expected()) for b, r in buckets.items() if r.expected() > 0
        )
        if not known:
            return -1
        if bucket <= known[0][0]:
            return known[0][1]
        if bucket >= known[-1][0]:
            b_max, t_max = known[-1]
            return int(t_max * bucket / b_max)
        for (b_lo, t_lo), (b_hi, t_hi) in zip(known, known[1:]):
            if b_lo < bucket < b_hi:
                frac = (bucket - b_lo) / (b_hi - b_lo)
                return int(t_lo + frac * (t_hi - t_lo))
        return known[-1][1]

    def has(self, key: SubgraphKey) -> bool:
        return key in self._db

    def get_worst_model_latency(self, model_id: int) -> int:
        """Max expected over this model's whole-model subgraphs
        (bucket-1 records: SLO scales are per-request)."""
        worst = 0
        with self._lock:
            for key, buckets in self._db.items():
                if key.model_id == model_id and 1 in buckets:
                    worst = max(worst, max(buckets[1].expected(), 0))
        return worst

    # ------------------------------------------------------------------
    def dump_profile(self, path: Optional[str] = None) -> None:
        path = path or self._path
        if not path:
            return
        with self._lock:
            payload = {
                "hash": self._hash,
                "latency": {
                    _key_str(k): {
                        str(b): {
                            "profiled": r.profiled,
                            "moving_averaged": r.moving_averaged,
                        }
                        for b, r in buckets.items()
                    }
                    for k, buckets in self._db.items()
                },
            }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    def load_profile(self, path: str) -> bool:
        """Load a persisted profile; stale hashes are ignored
        (reference: latency_estimator.cc:215-221).  Accepts both the
        bucketed format and the round-1 flat (bucket-1-only) format."""
        if not os.path.exists(path):
            return False
        with open(path) as f:
            payload = json.load(f)
        if payload.get("hash") != self._hash:
            return False
        with self._lock:
            for ks, entry in payload.get("latency", {}).items():
                model_s, worker_s, units_s = ks.split(":")
                units = frozenset(
                    int(u) for u in units_s.split(",") if u != ""
                )
                key = SubgraphKey(int(model_s), int(worker_s), units)
                if "profiled" in entry:  # legacy flat record = bucket 1
                    entry = {"1": entry}
                for bs, rec in entry.items():
                    self._db.setdefault(key, {})[int(bs)] = LatencyRecord(
                        profiled=int(rec["profiled"]),
                        moving_averaged=int(rec["moving_averaged"]),
                    )
                if 1 in self._db.get(key, {}):
                    self._write_through(key, self._db[key][1])
        return True
