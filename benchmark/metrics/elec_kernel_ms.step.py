"""The elec/vdw pair kernel K3 (``csrc/elec_vdw_pairs.cu``: the per-tile
kernel and the row sums of ``csrc/sum_rows.cuh``, which no other kernel
launches where K3 runs): their device time in the profiler over the GSO
steps.  The kernels are found by these names; a program without them gives
nothing."""

NAME = "elec_kernel_ms.step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "pair kernel K3"
MOVES = "poses_per_s"
WRAPS = []
KERNELS = ("elec_vdw_pairs_kernel", "sum_rows_kernel")


def device_ns(run):
    """ns of the K3 kernels' device events, or None without a device trace
    or any such event."""
    if run.trace is None:
        return None
    ns = [b - a for name, a, b in run.trace.events if any(k in name for k in KERNELS)]
    return sum(ns) if ns else None


def read(run):
    ns, steps = device_ns(run), run.steps()
    if ns is None or not steps:
        return None
    return ns * 1e-6 / steps
