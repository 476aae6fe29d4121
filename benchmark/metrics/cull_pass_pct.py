"""The share of the box cull's (pose, tile pair) entries that keep their
energy bit: 100 x the program's counters ``cull_kept`` / ``cull_checked``
(the cull kernel's own tally of the moved poses' entries and of those
within the energy cutoff), summed over the traced jobs.  A program that
records neither gives nothing."""

from ldbench import program_trace

NAME = "cull_pass_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "kernel prep and GSO launches"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    checked = sum(c.get("cull_checked", 0) for _, _, c in jobs)
    kept = sum(c.get("cull_kept", 0) for _, _, c in jobs)
    if not checked:
        return None
    return 100.0 * kept / checked
