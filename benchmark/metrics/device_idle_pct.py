"""The device's idle share: the part of the traced jobs' window (between
the two marker kernels around it) in which no kernel, copy or set ran on
the card, from the union of the profiler's device intervals."""

from ldbench.devtrace import busy_ns

NAME = "device_idle_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    busy = busy_ns(run.trace)
    return 100.0 * (1.0 - busy / (hi - lo))
