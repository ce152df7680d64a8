"""Device: the share of the card's int8 peak, in %, while it was busy: 2
MAC of every request answered while the trace ran (the model's
conv-family ops, portbench/work.py) over the union of the traced
device events and 1,979 TOP/s.  The whole step's share beside the conv
kernels' roofline: both move card_ms_per_req."""

from portbench.work import INT8_OPS_PER_S


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.trace_requests:
        return None
    ops = 2.0 * run.mac_per_request * run.trace_requests
    return 100.0 * ops / run.trace.busy_s / INT8_OPS_PER_S
