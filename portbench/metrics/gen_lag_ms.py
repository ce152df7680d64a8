"""The load generator's 95th-percentile lateness: each window request's
send time less its due time, in ms."""

from portbench.metrics._common import percentile


def read(run):
    return percentile([(r.sent - r.due) * 1e3 for r in run.window], 0.95)
