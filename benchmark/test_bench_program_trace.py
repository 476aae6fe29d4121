"""The readers of the program's own spans and counter
(``ldbench/program_trace.py`` and the metrics built on it) on synthetic
runs: job files with ``trace`` lines and a device trace made by hand; and
one traced run of each cell on the CPU at a small size.

    python -m pytest benchmark/test_bench_program_trace.py -q
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402
from ldbench import manifest, program_trace  # noqa: E402
from ldbench.devtrace import DeviceTrace, busy_intervals  # noqa: E402
from ldbench.record import RunRecord  # noqa: E402

BASES = ("prep_host_ms.job", "energy_host_ms.step", "move_host_ms.step", "write_ms.snapshot",
         "pair_kernel_ns.pose", "step_idle_pct")
K1 = "void_dfire_pairs_kernel<false>"


def job_file(d, lines):
    d.mkdir(parents=True, exist_ok=True)
    (d / "metrics.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))


def trace(spans, poses=None):
    return {"event": "trace", "spans": [list(s) for s in spans],
            "counters": {} if poses is None else {"poses_scored": poses}}


def segment():
    return {"event": "segment", "seconds": 1.0}


def synthetic(tmp_path, events=(), window=(0, 1000)):
    """Two jobs of 2 steps each, on a window of 0-1000 ns.

    job 0 (0-480): read_inputs 0-40, runner_setup 40-100, energy 100-150 and
    200-260, move 150-200 and 260-300, write_text 300-320, write_sidecar
    320-360; 200 + 150 poses scored.  job 1 (500-990): read_inputs 500-520,
    runner_setup 520-560, energy 600-700 and 750-800, move 700-750 and
    800-820; 200 + 120 poses; no writes."""
    j0 = [segment(), trace([("read_inputs", 0, 40), ("runner_setup", 40, 100),
                            ("energy", 100, 150), ("move", 150, 200)], 200),
          segment(), trace([("energy", 200, 260), ("move", 260, 300),
                            ("write_text", 300, 320), ("write_sidecar", 320, 360)], 150),
          {"event": "summary"}]
    j1 = [segment(), trace([("read_inputs", 500, 520), ("runner_setup", 520, 560),
                            ("energy", 600, 700), ("move", 700, 750)], 200),
          segment(), trace([("energy", 750, 800), ("move", 800, 820)], 120),
          {"event": "summary"}]
    jobs = []
    for k, (lines, t) in enumerate(((j0, (0, 480)), (j1, (500, 990)))):
        job_file(tmp_path / str(k), lines)
        jobs.append({"job": k, "dir": tmp_path / str(k), "ok": True, "t0": t[0], "t1": t[1],
                     "steps": 2, "poses": 400})
    dev = None
    if events is not None:
        lo, hi = window
        dev = DeviceTrace(list(events), window, 0, busy_intervals(list(events), 0, lo, hi))
    return RunRecord(jobs, 1.0, None, dev)


def test_host_spans_per_job_step_and_snapshot(tmp_path):
    rec = synthetic(tmp_path)
    m = {name: manifest.metric(name).read(rec) for name in BASES}
    assert m["prep_host_ms.job"] == pytest.approx(1e-6 * (100 + 60) / 2)
    assert m["energy_host_ms.step"] == pytest.approx(1e-6 * (50 + 60 + 100 + 50) / 4)
    assert m["move_host_ms.step"] == pytest.approx(1e-6 * (50 + 40 + 50 + 20) / 4)
    assert m["write_ms.snapshot"] == pytest.approx(1e-6 * (20 + 40) / 1)


def test_step_idle_pct_intersects_gaps_with_spans(tmp_path):
    """The device busy 0-120, 180-210, 255-580 and 790-1000: its idle gaps
    120-180 (inside energy 100-150 and move 150-200), 210-255 (inside
    energy 200-260) and 580-790, which starts in no span (runner_setup
    ends at 560, energy starts at 600) and runs through energy 600-700,
    move 700-750 and into energy 750-800: only its parts inside energy or
    move count."""
    events = [("k", 0, 120), ("k", 180, 210), ("k", 255, 580), ("k", 790, 1000)]
    rec = synthetic(tmp_path, events)
    inside = 60 + 45 + (790 - 600)
    assert manifest.metric("step_idle_pct").read(rec) == pytest.approx(100 * inside / 1000)
    # A gap crossing a span's edge: busy until 130 and from 330: the gap
    # 130-330 meets energy 130-150, move 150-200, energy 200-260 and move
    # 260-300, and leaves out 300-330 (the writes).
    rec = synthetic(tmp_path / "b", [("k", 0, 130), ("k", 330, 1000)])
    assert manifest.metric("step_idle_pct").read(rec) == pytest.approx(100 * 170 / 1000)
    split = program_trace.idle_by_span(rec)
    assert split["energy"] == pytest.approx(80e-9) and split["move"] == pytest.approx(90e-9)
    assert split["write_text"] == pytest.approx(20e-9)
    assert split["write_sidecar"] == pytest.approx(10e-9)
    assert split["none"] == pytest.approx(0) and split["idle"] == pytest.approx(200e-9)
    assert sum(split[n] for n in (*program_trace.SPANS, "none")) == pytest.approx(split["idle"])


def test_overlap_against_a_sample_by_sample_count():
    rng = np.random.default_rng(3)
    a = program_trace.union(np.sort(rng.integers(0, 2000, (60, 2)), axis=1))
    b = program_trace.union(np.sort(rng.integers(0, 2000, (40, 2)), axis=1))
    mask = np.zeros((2, 2000), bool)
    for k, x in enumerate((a, b)):
        for s, e in x:
            mask[k, s:e] = True
    assert program_trace.overlap_ns(a, b) == int((mask[0] & mask[1]).sum())


def test_pair_kernel_ns_per_scored_pose(tmp_path):
    """The kernels pair_kernel_ms.step names (one of them, twice) over the
    poses scored in both jobs; another kernel is left out."""
    events = [(K1, 100, 130), ("void_at_native_elementwise", 130, 400),
              ("void_sum_rows_kernel", 600, 610), (K1, 750, 790)]
    rec = synthetic(tmp_path, events)
    assert manifest.metric("pair_kernel_ns.pose").read(rec) == pytest.approx(
        (30 + 10 + 40) / (200 + 150 + 200 + 120))


@pytest.mark.parametrize("base", BASES)
def test_swarm1_twin_is_the_base(base):
    twin = manifest.metric(f"{base}.swarm1")
    assert twin.read is manifest.metric(base).read and twin.UNIT == manifest.metric(base).UNIT
    assert (twin.NAME, twin.MOVES) == (f"{base}.swarm1", "poses_per_s.swarm1")


def test_no_trace_line_reads_none(tmp_path):
    """A program that writes no trace line (segments and a summary only),
    or no file at all, gives None for every reader, never 0."""
    rec = synthetic(tmp_path, [(K1, 0, 10)])
    for j in rec.jobs:
        job_file(j["dir"], [segment(), segment(), {"event": "summary"}])
    assert all(manifest.metric(name).read(rec) is None for name in BASES)
    for j in rec.jobs:
        (j["dir"] / "metrics.jsonl").unlink()
    assert all(manifest.metric(name).read(rec) is None for name in BASES)
    assert program_trace.traced(rec) == []


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,override", [
    ("1ppe-dfire-rigid.swarm1", {}),
    ("1k4c-dfire-membrane.glob32", {"config": {"membrane": {"beads": 40}, "swarm_centres": 3},
                                    "traffic": {"swarms": 3}}),
])
def test_traced_cpu_run_reports_the_program_spans(capsys, cell, override):
    """A traced run on the CPU at a small size reports each span reader of
    the cell; the device's readers, with no device trace there, report
    nothing."""
    small = {"config": {"receptor_atoms": 300, "ligand_atoms": 60, "glowworms": 30,
                        "steps": 20},
             "min_job_s": 0.3, "check": {"jobs": 1, "swarms": 1, "segments": 2,
                                         "score_snapshots": 1}}
    code = run.main(["--workload", cell, "--seed", str(2 ** 31 + 11), "--seconds", "1",
                     "--trace", "1", "--platform", "cpu",
                     "--override", json.dumps(run.merge(small, override))])
    assert code == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tag = ".swarm1" if cell.endswith("swarm1") else ""
    got = result["metrics"]
    for base in BASES[:4]:
        assert got[base + tag]["value"] > 0, base
    for base in BASES[4:]:
        assert base + tag not in got
