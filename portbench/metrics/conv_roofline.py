"""Kernels: the conv-family graph ops' share of their roofline, in %: the
sum over the windows traced of each op's least time (2 MAC over the int8
peak or its bytes over HBM's rate, the larger; portbench/work.py) over
the device time the trace attributes to those ops.  Counted per graph
op from the model's shapes at the window sizes served, so it is the same
whichever kernel runs an op."""

from portbench.metrics._common import is_conv
from portbench.work import bound_s


def read(run):
    if run.trace is None or not run.trace_windows:
        return None
    device = sum(v for k, v in run.trace.device_s.items() if is_conv(k))
    if device <= 0:
        return None
    return 100.0 * bound_s(run.work, run.trace_windows) / device
