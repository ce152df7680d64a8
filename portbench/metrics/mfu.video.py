"""Device: the share of the int8 peak, in %, while windows ran: 2 MAC of
every request answered in the window over the union of the dispatch
windows' [invoke_time, end_time] (the engine's job stamps) and 1,979
TOP/s."""

from portbench.trace import union
from portbench.work import INT8_OPS_PER_S


def read(run):
    spans = {(r.invoke_us, r.end_us) for r in run.records
             if r.ok and r.invoke_us and run.t0_us <= r.invoke_us < run.t1_us}
    busy = sum(e - s for s, e in union(list(spans))) / 1e6
    ops = 2.0 * run.mac_per_request * run.answered_in_window
    return 100.0 * ops / busy / INT8_OPS_PER_S if busy > 0 and ops else None
