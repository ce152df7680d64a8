"""Executor and program: kernel events in the device trace per request
answered while the trace ran."""


def read(run):
    if run.trace is None or not run.trace_requests or not run.trace.kernels:
        return None
    return run.trace.kernels / run.trace_requests
