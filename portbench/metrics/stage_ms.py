"""Worker: host ms a window in ``band.stage`` on the worker's dispatch
thread (the ring views, pad, stack, pin and the host-to-device copy's
launch), over the executor's windows in the traced part (program span)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    n = spans.windows(run)
    if s is None or s.summary.worker is None or not n:
        return None
    return s.summary.seconds("band.stage", s.summary.worker) / n * 1e3
