"""The command line and input layer a job: its wall time less the seconds
of its segments (``--metrics``), i.e. argv, reading the PDB files,
setup.json and positions, the scoring models, the DFIRE table and the
energy's set-up, before the first step; mean over jobs."""

NAME = "prep_ms.job"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "command line and input layer"
MOVES = "poses_per_s"
WRAPS = []


def read(run):
    jobs = [j for j in run.done if j.get("segments")]
    if not jobs:
        return None
    return 1e3 * sum((j["t1"] - j["t0"]) * 1e-9 - sum(j["segments"]) for j in jobs) / len(jobs)
