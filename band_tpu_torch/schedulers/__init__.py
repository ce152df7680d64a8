"""Schedulers of the PyTorch port.

Only the fixed-worker schedulers are ported so far; the engine raises
ConfigError for the others (round_robin, shortest_expected_latency,
HEFT, least_slack_first), which band_tpu/schedulers/ still holds."""

from .fixed_worker import FixedWorkerScheduler  # noqa: F401
