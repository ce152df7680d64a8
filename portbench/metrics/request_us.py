"""Engine and planner: host µs a request in ``band.request`` (the
caller's ``Engine.request_async_batch``: validation, the job, the input
ring, the planner's enqueue), over the requests answered in the traced
part (program span)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or not run.trace_requests:
        return None
    return s.summary.seconds("band.request") / run.trace_requests * 1e6
