"""The device's idle share inside the GSO steps: 100 x the device's idle
time (``ldbench.devtrace.idle_gaps``) that falls inside the program's
``energy`` and ``move`` spans, by interval intersection, over the traced
window.  The idle that fewer host launches a step would remove."""

from ldbench import program_trace

NAME = "step_idle_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    idle = program_trace.idle_in(run, {"energy", "move"})
    if idle is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * idle / (hi - lo)
