"""Executor and program: the share, in %, of the rows stacked into
windows that are padding (copies of a window's first request filling it
to its bucket): the deltas of the program's ``rows_padded`` over
``rows_stacked`` in the traced part (program counter)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or s.counters.get("rows_stacked", 0) <= 0:
        return None
    return 100.0 * s.counters["rows_padded"] / s.counters["rows_stacked"]
