"""Device: the share of the traced window, in %, in which no kernel,
copy or memset ran (one less the union of their intervals over the
window)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
