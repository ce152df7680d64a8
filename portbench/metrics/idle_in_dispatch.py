"""Device: the share, in %, of the card's idle time in the traced window
(no kernel, copy or memset running) that falls inside the worker's
``band.window`` spans, while the host dispatches a window (program span
over the device trace)."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or s.summary.idle_s <= 0:
        return None
    return 100.0 * s.summary.idle_in_window_s / s.summary.idle_s
