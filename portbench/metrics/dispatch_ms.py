"""Executor and program: host ms a window inside the graph-op spans
(opNNN_*) on the worker's thread, over the windows whose first graph op
the trace holds."""


def read(run):
    if run.trace is None or not run.trace.worker_windows:
        return None
    return run.trace.worker_op_s / run.trace.worker_windows * 1e3
