"""The readers of the box cull's metrics (``metrics/cull_ms.step.py``,
``metrics/cull_pass_pct.py``) on synthetic runs: job files with ``trace``
lines and a device trace made by hand.

    python -m pytest benchmark/test_bench_cull_metrics.py -q
"""

import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from ldbench import manifest  # noqa: E402
from ldbench.devtrace import DeviceTrace, busy_intervals  # noqa: E402
from ldbench.record import RunRecord  # noqa: E402

CULL = "void (anonymous namespace)::cull_bits_kernel((anonymous namespace)::Args)"
K2 = "void (anonymous namespace)::dfire_pairs_worklist_kernel<false>(Inputs)"


def run(tmp_path, counters, events):
    """Two jobs of 10 steps, each with two trace lines of the counters
    given (None: no counter), on a device trace of ``events``."""
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
    dev = DeviceTrace(events, (0, 1000), 0, busy_intervals(events, 0, 0, 1000))
    return RunRecord(jobs, 1.0, None, dev)


def test_cull_ms_reads_the_kernel_by_name(tmp_path):
    """The cull kernel's device ns over the 20 steps; K2 and the ATen
    kernels are left out, and pair_kernel_ms.step does not take it."""
    events = [(CULL, 0, 300_000), (K2, 300_000, 900_000), ("void at::native::reduce_kernel", 0, 5),
              (CULL, 900_000, 1_000_000)]
    rec = run(tmp_path, [{"poses_scored": 5}], events)
    assert manifest.metric("cull_ms.step").read(rec) == pytest.approx(0.4 / 20)
    assert manifest.metric("pair_kernel_ms.step").read(rec) == pytest.approx(0.6 / 20)
    assert manifest.metric("cull_ms.step.swarm1").read is manifest.metric("cull_ms.step").read


def test_cull_pass_pct_sums_the_counters(tmp_path):
    counters = [{"poses_scored": 5, "cull_checked": 1000, "cull_kept": 250},
                {"poses_scored": 5, "cull_checked": 600, "cull_kept": 150}]
    rec = run(tmp_path, counters, [(K2, 0, 10)])
    assert manifest.metric("cull_pass_pct").read(rec) == pytest.approx(100.0 * 800 / 3200)
    twin = manifest.metric("cull_pass_pct.swarm1")
    assert twin.read is manifest.metric("cull_pass_pct").read
    assert twin.MOVES == "poses_per_s.swarm1"


def test_a_program_without_the_kernel_reads_none(tmp_path):
    """The parent's program: no cull kernel in the trace, no cull counter
    in the trace lines; both readers give None, never 0."""
    rec = run(tmp_path, [{"poses_scored": 5}], [(K2, 0, 10)])
    assert manifest.metric("cull_ms.step").read(rec) is None
    assert manifest.metric("cull_pass_pct").read(rec) is None
