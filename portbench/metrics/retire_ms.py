"""Worker: host ms a window in ``band.retire.finish`` on the retire
thread (the latency update, the jobs' completion, the callbacks), over
the executor's windows in the traced part (program span)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    n = spans.windows(run)
    if s is None or not n:
        return None
    return s.summary.seconds("band.retire.finish") / n * 1e3
