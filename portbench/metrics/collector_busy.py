"""Load generator: the share of the window, in %, that the client's
collector threads spent handling answers (the copy to the host, the
bookkeeping and the loop's next send), averaged over the threads.  Near
100% the client, not the system, paces the answers."""


def read(run):
    busy = run.collector_busy_s
    return 100.0 * busy / run.seconds / run.collectors if busy else None
