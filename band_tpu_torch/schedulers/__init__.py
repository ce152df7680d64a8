"""Schedulers of the PyTorch port: copies of band_tpu/schedulers/ on
this package's ``common`` and ``EngineBase`` (they are
framework-neutral)."""

from .fixed_worker import (  # noqa: F401
    FixedWorkerGlobalQueueScheduler,
    FixedWorkerScheduler,
)
from .heft import HEFTScheduler  # noqa: F401
from .least_slack_first import LeastSlackFirstScheduler  # noqa: F401
from .round_robin import RoundRobinScheduler  # noqa: F401
from .shortest_expected_latency import (  # noqa: F401
    ShortestExpectedLatencyScheduler,
)
