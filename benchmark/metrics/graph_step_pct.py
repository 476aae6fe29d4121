"""The share of the GSO steps that the runner served by replaying its CUDA
graphs: 100 x the program's counter ``graph_steps`` over the steps of the
traced jobs.  A program that records no such counter (one whose steps all
run op by op, or one without the graphs) gives nothing."""

from ldbench import program_trace

NAME = "graph_step_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "farm, runner and GSO step"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    if not any("graph_steps" in c for _, _, c in jobs):
        return None
    replayed = sum(c.get("graph_steps", 0) for _, _, c in jobs)
    return 100.0 * replayed / sum(j["steps"] for j, _, _ in jobs)
