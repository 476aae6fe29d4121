"""The pair kernels K1 and K2 a scored pose: the device ns of the kernels
``pair_kernel_ms.step`` names, over the poses the energy calls were asked
to score (the program's ``poses_scored`` counter, summed over the traced
jobs).  Unlike a figure a step, it does not fall because a converged swarm
moved, and so rescored, fewer poses."""

from ldbench import manifest, program_trace

NAME = "pair_kernel_ns.pose"
UNIT = "ns/pose"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "pair kernels K1 and K2"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    if run.trace is None:
        return None
    poses = sum(c.get("poses_scored", 0) for _, _, c in program_trace.traced(run))
    kernels = manifest.metric("pair_kernel_ms.step").KERNELS
    ns = sum(b - a for name, a, b in run.trace.events if any(k in name for k in kernels))
    if not poses or not ns:
        return None
    return ns / poses
