"""Kernel preparation and the GSO step's launches: the device operations
(kernels, copies, sets) the profiler saw during the timed jobs, over the
GSO steps."""

NAME = "device_ops.step"
UNIT = "ops/step"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernel prep and GSO launches"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    steps = run.steps()
    if run.trace is None or not steps:
        return None
    return len(run.trace.events) / steps
