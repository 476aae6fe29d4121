"""The command line and input layer a job, from inside the program: the
host ms of its ``read_inputs`` span (argv, the output directory, the PDB
files, setup.json, the positions, the scoring models) and its
``runner_setup`` span (the runner: the energy mode, ``make_energy``'s
tables and uploads, the initial state, the ``--metrics`` file, the random
stream and its copy), which tile a job's host time before its first step;
mean over the jobs.  The in-program twin of ``prep_ms.job``."""

from ldbench import program_trace

NAME = "prep_host_ms.job"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "command line and input layer"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    if not program_trace.spans_of(jobs, {"read_inputs", "runner_setup"}):
        return None
    return 1e-6 * program_trace.total_ns(jobs, {"read_inputs", "runner_setup"}) / len(jobs)
