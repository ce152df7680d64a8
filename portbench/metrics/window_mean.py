"""Worker: requests a dispatch window, the requests the engine invoked
inside the measured window over the executor's windows there
(``Executor.windows`` deltas)."""


def read(run):
    windows = sum(run.windows.values())
    invoked = sum(1 for r in run.records
                  if r.ok and run.t0_us <= r.invoke_us < run.t1_us)
    return invoked / windows if windows else None
