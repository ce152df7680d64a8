"""Device: the card's time an answer, in ms: the union of the kernel,
copy and memset intervals over the whole window (a trace of the card's
activity alone, from the window's opening to its close) over the
answers the host received in that span.  What a request costs in card
time; the host's pace, which sets how long the card idles between
windows, does not enter it."""


def read(run):
    if not run.card_busy_s or not run.card_requests:
        return None
    return 1e3 * run.card_busy_s / run.card_requests
