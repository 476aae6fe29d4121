"""The output layer, from inside the program: the host ms of the
``write_text`` (``gso_N.out`` by the native writer) and ``write_sidecar``
(the ``.npz``) spans, over the snapshots (``write_text`` spans) of the
traced jobs.  The in-program twin of ``snapshot_ms``."""

from ldbench import program_trace

NAME = "write_ms.snapshot"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "output layer"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = program_trace.traced(run)
    snapshots = len(program_trace.spans_of(jobs, {"write_text"}))
    if not snapshots:
        return None
    return 1e-6 * program_trace.total_ns(jobs, {"write_text", "write_sidecar"}) / snapshots
