"""Worker: the share of the traced window, in %, in which the worker's
dispatch thread waited in ``band.wait`` (no job, paused, or its in-flight
depth reached) (program span)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or s.summary.worker is None or s.summary.window_s <= 0:
        return None
    return 100.0 * s.summary.seconds("band.wait", s.summary.worker) \
        / s.summary.window_s
