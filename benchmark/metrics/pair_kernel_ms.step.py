"""The pair kernels K1 and K2 (``csrc/dfire_pairs.cu``: the per-tile
kernel, the work-list kernel and its compaction, and the row sums of
``csrc/sum_rows.cuh``): their device time in the profiler over the GSO
steps.  The kernels are found by these names."""

NAME = "pair_kernel_ms.step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "pair kernels K1 and K2"
MOVES = "poses_per_s"
WRAPS = []
KERNELS = ("dfire_pairs_kernel", "dfire_pairs_worklist_kernel", "compact_tiles_kernel",
           "sum_rows_kernel")


def read(run):
    steps = run.steps()
    if run.trace is None or not steps:
        return None
    ns = [b - a for name, a, b in run.trace.events if any(k in name for k in KERNELS)]
    if not ns:
        return None
    return sum(ns) * 1e-6 / steps
