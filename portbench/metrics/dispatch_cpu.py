"""Worker: the share, in %, of the dispatch thread's wall time in its
windows (``band.window``) in which it ran on a core: the deltas of the
program's ``dispatch_cpu_ns`` over ``dispatch_wall_ns`` in the traced part
(program counter).  Well under 100%: the thread waits inside its windows,
for the interpreter lock, a core or the device."""

from portbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None or s.counters.get("dispatch_wall_ns", 0) <= 0:
        return None
    return 100.0 * s.counters["dispatch_cpu_ns"] \
        / s.counters["dispatch_wall_ns"]
