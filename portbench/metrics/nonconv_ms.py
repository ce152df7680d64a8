"""Lowerings: device ms per request attributed to graph ops outside
CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED and TRANSPOSE_CONV (the
requant chains, PReLU tables, MEAN, SOFTMAX, shape ops), per request
answered while the trace ran."""

from portbench.metrics._common import is_conv
from portbench.trace import GRAPH_OP


def read(run):
    if run.trace is None or not run.trace_requests:
        return None
    s = sum(v for k, v in run.trace.device_s.items()
            if GRAPH_OP.match(k) and not is_conv(k))
    return s / run.trace_requests * 1e3 if s else None
