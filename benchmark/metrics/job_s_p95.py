"""The 95th percentile of the jobs' wall times, from the ``cli.main`` call
to its return with every snapshot on disk; a job that failed counts as
the slowest.  Linear interpolation between order statistics."""

import statistics

NAME = "job_s_p95"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    times = [(j["t1"] - j["t0"]) * 1e-9 if j["ok"] else float("inf") for j in run.jobs]
    if len(times) < 2:
        return times[0] if times else None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
