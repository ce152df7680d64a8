"""Engine and planner: host µs a request in ``band.plan`` (the planner's
passes that found work: local queues, schedule, enqueue to the worker),
over the requests answered in the traced part (program span)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or not run.trace_requests:
        return None
    return s.summary.seconds("band.plan") / run.trace_requests * 1e6
