"""The 95th percentile, over the window's requests, of due time to answer
on the host, in ms (a missing answer counts as the longest)."""

from portbench.metrics._common import latencies_ms, percentile


def read(run):
    return percentile(latencies_ms(run), 0.95)
