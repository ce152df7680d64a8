"""Engine and planner: the mean of invoke_time - enqueue_time (the
engine's own job stamps) over the window's answered requests, in ms."""


def read(run):
    waits = [(r.invoke_us - r.enqueue_us) / 1e3 for r in run.window
             if r.ok and r.invoke_us]
    return sum(waits) / len(waits) if waits else None
