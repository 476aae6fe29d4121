"""Kernel preparation and the GSO step's launches, from inside the program:
the host ms of the ``energy`` spans (the rescoring gate, the pose order,
transform and box cull, the pair kernel's wrapper and launch, the finish
and bias), over the GSO steps of the traced jobs."""

from ldbench import program_trace

NAME = "energy_host_ms.step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "kernel prep and GSO launches"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    if not program_trace.spans_of(jobs, {"energy"}):
        return None
    return 1e-6 * program_trace.total_ns(jobs, {"energy"}) / sum(j["steps"] for j, _, _ in jobs)
