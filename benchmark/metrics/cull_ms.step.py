"""The box cull (``csrc/cull_bits.cu``, the kernel of ``ops/cull.py``
``cull_tile_bits``): its device time in the profiler over the GSO steps.
The kernel is found by this name; a program without it gives nothing."""

NAME = "cull_ms.step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernel prep and GSO launches"
MOVES = "poses_per_s"
WRAPS = []
KERNELS = ("cull_bits_kernel",)


def read(run):
    steps = run.steps()
    if run.trace is None or not steps:
        return None
    ns = [b - a for name, a, b in run.trace.events if any(k in name for k in KERNELS)]
    if not ns:
        return None
    return sum(ns) * 1e-6 / steps
