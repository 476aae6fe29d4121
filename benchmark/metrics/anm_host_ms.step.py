"""The receptor and the ligand built from their ANM modes, from inside the
program: the host ms of the ``anm_pose`` spans (the mode sums and their
cull slack, inside ``energy``), over the GSO steps of the traced jobs.  A
program that records no such span gives nothing."""

from ldbench import program_trace

NAME = "anm_host_ms.step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "kernel prep and GSO launches"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    if not program_trace.spans_of(jobs, {"anm_pose"}):
        return None
    return 1e-6 * program_trace.total_ns(jobs, {"anm_pose"}) / sum(j["steps"] for j, _, _ in jobs)
