"""Engine and planner: host µs a request in ``band.get_outputs`` (the
finished job, the device-to-host copy, the output ring), over the
requests answered in the traced part (program span)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or not run.trace_requests:
        return None
    return s.summary.seconds("band.get_outputs") / run.trace_requests * 1e6
