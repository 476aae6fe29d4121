"""The farm's, the runner's and the GSO step's own host work, from inside
the program: the host ms of the ``move`` spans (luciferin, neighbours,
roulette, moves and vision; the farm's vmap over swarms), over the GSO
steps of the traced jobs."""

from ldbench import program_trace

NAME = "move_host_ms.step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "farm, runner and GSO step"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    if not program_trace.spans_of(jobs, {"move"}):
        return None
    return 1e-6 * program_trace.total_ns(jobs, {"move"}) / sum(j["steps"] for j, _, _ in jobs)
