"""The reader of the share of steps replayed from CUDA graphs
(``metrics/graph_step_pct.py``) on synthetic runs: job files with ``trace``
lines made by hand.

    python -m pytest benchmark/test_bench_graph_metrics.py -q
"""

import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from ldbench import manifest  # noqa: E402
from ldbench.record import RunRecord  # noqa: E402


def run(tmp_path, counters):
    """Two jobs of 10 steps, each with a trace line a segment of the
    counters given."""
    jobs = []
    for k in range(2):
        d = tmp_path / str(k)
        d.mkdir(parents=True)
        lines = []
        for c in counters:
            lines += [{"event": "segment", "seconds": 1.0},
                      {"event": "trace", "spans": [["energy", 10, 20]], "counters": c}]
        (d / "metrics.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))
        jobs.append({"job": k, "dir": d, "ok": True, "t0": 0, "t1": 100, "steps": 10,
                     "poses": 100})
    return RunRecord(jobs, 1.0, None, None)


def test_graph_step_pct_counts_the_replayed_steps(tmp_path):
    """Each job's first step runs op by op, the other nine are replayed."""
    rec = run(tmp_path, [{"poses_scored": 5, "graph_steps": 4},
                         {"poses_scored": 5, "graph_steps": 5}])
    assert manifest.metric("graph_step_pct").read(rec) == pytest.approx(90.0)
    twin = manifest.metric("graph_step_pct.swarm1")
    assert twin.read is manifest.metric("graph_step_pct").read
    assert (twin.NAME, twin.MOVES) == ("graph_step_pct.swarm1", "poses_per_s.swarm1")


def test_a_program_without_graphs_reads_none(tmp_path):
    """The parent's program, or steps all op by op: no ``graph_steps`` in
    the trace lines gives None, never 0."""
    rec = run(tmp_path, [{"poses_scored": 5}])
    assert manifest.metric("graph_step_pct").read(rec) is None
