"""The program's spans and counter (``lightdock_tpu_torch.utils.metrics``)
through the command line on the CPU: what ``--metrics`` writes as
``trace`` lines, the ``poses_scored`` counter against an independent count,
the farm's spans, the clock, ``--profile``'s ranges, and that nothing is
recorded or counted without ``--metrics``.  Complexes of 60 x 30 atoms
written by ``standin.write_complex``, 10 glowworms, 20 steps (snapshots at
steps 1, 10 and 20; segments of 10)."""

import contextlib
import io
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch import cli, standin  # noqa: E402
from lightdock_tpu_torch.engine.runner import GsoTorchRunner  # noqa: E402
from lightdock_tpu_torch.simulation import load_simulation  # noqa: E402
from lightdock_tpu_torch.utils import metrics  # noqa: E402

G, STEPS, SWARMS = 10, 20, 3
SNAPSHOTS = 3  # steps 1, 10, 20
SEGMENT = 10


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def complex_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    setup, positions = standin.write_complex(root, "dfire", 60, 30, G, n_swarms=SWARMS,
                                             seed=7)
    return root, setup, positions


def run_cli(work, argv):
    """``cli.main(argv)`` in ``work``; returns the perf_counter_ns bounds of
    the call."""
    work.mkdir(parents=True, exist_ok=True)
    old = os.getcwd()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter_ns()
            assert cli.main([str(a) for a in argv]) == 0
            t1 = time.perf_counter_ns()
    finally:
        os.chdir(old)
    return t0, t1


def events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def spans_of(evs, name=None):
    return [(n, a, b) for e in evs if e["event"] == "trace" for n, a, b in e["spans"]
            if name is None or n == name]


@pytest.fixture(scope="module")
def one_swarm(complex_files, tmp_path_factory):
    """A one-swarm run with --metrics: (events, the call's bounds)."""
    _, setup, positions = complex_files
    work = tmp_path_factory.mktemp("one")
    bounds = run_cli(work, [setup, positions[0], STEPS, "dfire", "--platform", "cpu",
                            "--metrics", work / "m.jsonl"])
    return events(work / "m.jsonl"), bounds


@pytest.fixture(scope="module")
def farm(complex_files, tmp_path_factory):
    root, setup, _ = complex_files
    work = tmp_path_factory.mktemp("farm")
    run_cli(work, [setup, root / "initial_positions_*.dat", STEPS, "dfire", "--platform",
                   "cpu", "--metrics", work / "m.jsonl"])
    return events(work / "m.jsonl")


def check_step_spans(evs, writes):
    """One read_inputs, one runner_setup before the steps, one energy and
    one move a step (the energy first), ``writes`` write_text and
    write_sidecar spans; spans of one name never overlap; each segment's
    trace line holds its own steps' spans."""
    assert [e["event"] for e in evs] == ["segment", "trace"] * (STEPS // SEGMENT) + ["summary"]
    counts = {}
    for name, _, _ in spans_of(evs):
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"read_inputs": 1, "runner_setup": 1, "energy": STEPS, "move": STEPS,
                      "write_text": writes, "write_sidecar": writes}
    for name in counts:
        s = sorted(spans_of(evs, name), key=lambda x: x[1])
        assert all(a <= b for _, a, b in s), name
        assert all(s[i][2] <= s[i + 1][1] for i in range(len(s) - 1)), name
    energy = sorted(spans_of(evs, "energy"), key=lambda x: x[1])
    move = sorted(spans_of(evs, "move"), key=lambda x: x[1])
    for i in range(STEPS):
        assert energy[i][2] <= move[i][1]
        assert i + 1 == STEPS or move[i][2] <= energy[i + 1][1]
    (_, _, read_end), = spans_of(evs, "read_inputs")
    (_, setup_start, setup_end), = spans_of(evs, "runner_setup")
    assert read_end <= setup_start and setup_end <= energy[0][1]
    traces = [e for e in evs if e["event"] == "trace"]
    assert [sum(n == "energy" for n, _, _ in t["spans"]) for t in traces] == [SEGMENT] * 2


def test_one_swarm_trace_lines(one_swarm):
    """--metrics on one swarm: a trace line after each segment with the
    spans of the table in cli.py's docstring."""
    evs, _ = one_swarm
    check_step_spans(evs, SNAPSHOTS)


def test_farm_trace_lines(farm):
    """The glob's farm: one energy and one move a farm step, a write_text
    and a write_sidecar a swarm a snapshot."""
    check_step_spans(farm, SWARMS * SNAPSHOTS)


def independent_counts(setup, positions):
    """Poses scored at each step of one swarm: num_neighbors > 0 in the
    state before the step, from ``run_swarm``'s outputs (every pose on
    step 1)."""
    sim = load_simulation(setup, positions, "dfire")
    runner = GsoTorchRunner(sim.batch_params(dtype=np.dtype("float64")), sim.positions,
                            sim.seed, sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                            dtype=torch.float64, device="cpu", energy_mode="auto")
    _, outs = runner.run(STEPS)
    moved = (outs.num_neighbors > 0).sum(dim=1).tolist()
    return [G] + moved[:-1]


def segment_counts(evs):
    return [e["counters"]["poses_scored"] for e in evs if e["event"] == "trace"]


def test_poses_scored_counts_moved_poses(complex_files, one_swarm, farm):
    """poses_scored of each segment is the sum over its steps of the poses
    that moved in the step before (all G on step 1); the farm's, the sum of
    its swarms' own."""
    _, setup, positions = complex_files
    per_swarm = [independent_counts(setup, p) for p in positions]
    expect = [sum(c[:SEGMENT]) for c in per_swarm], [sum(c[SEGMENT:]) for c in per_swarm]
    assert segment_counts(one_swarm[0]) == [expect[0][0], expect[1][0]]
    assert segment_counts(farm) == [sum(expect[0]), sum(expect[1])]
    assert per_swarm[0][0] == G and sum(per_swarm[0]) < G * STEPS


def test_spans_on_the_callers_clock(one_swarm):
    """Every span lies within the cli.main call's perf_counter_ns bounds:
    the spans are on the clock the benchmark's window is on."""
    evs, (t0, t1) = one_swarm
    spans = spans_of(evs)
    assert spans and all(t0 <= a <= b <= t1 for _, a, b in spans)


def test_nothing_recorded_without_metrics(complex_files, tmp_path, monkeypatch):
    """Without --metrics no recorder is active during the run: span()
    hands out one shared object and the counter's call site is never
    reached; with --metrics that count would have raised."""
    _, setup, positions = complex_files
    seen = []
    real_span = metrics.span

    def watched(name):
        out = real_span(name)
        seen.append((metrics.recording(), id(out)))
        return out

    def refuse(name, value):
        raise AssertionError(f"count({name!r}) called")

    monkeypatch.setattr(metrics, "span", watched)
    monkeypatch.setattr(metrics, "count", refuse)
    argv = [setup, positions[0], STEPS, "dfire", "--platform", "cpu"]
    run_cli(tmp_path / "off", argv)
    assert len(seen) == 2 * STEPS
    assert {rec for rec, _ in seen} == {False} and len({i for _, i in seen}) == 1
    with pytest.raises(AssertionError, match="count"):
        run_cli(tmp_path / "on", argv + ["--metrics", tmp_path / "m.jsonl"])
    assert not metrics.recording()


def test_profile_ranges_carry_span_names(complex_files, tmp_path):
    """--profile without --metrics records nothing, but the Chrome trace
    holds a range of each step and write span's name."""
    _, setup, positions = complex_files
    run_cli(tmp_path, [setup, positions[0], SEGMENT, "dfire", "--platform", "cpu",
                       "--profile"])
    trace = json.loads((tmp_path / "swarm_0" / "torch_trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    for name in ("energy", "move", "write_text", "write_sidecar"):
        assert names.count(name) == {"energy": SEGMENT, "move": SEGMENT}.get(name, 2), name


def test_run_metrics_trace_lines(tmp_path, caplog):
    """RunMetrics under record(): a trace line after each segment with the
    spans closed and counters added since the last (a tensor's elements
    summed), the rest before the summary; none when nothing was recorded; no trace line in the DEBUG log;
    a nested record() reuses the active recorder."""
    path = tmp_path / "m.jsonl"
    caplog.set_level("DEBUG", logger="lightdock_tpu_torch.metrics")
    assert metrics.span("x") is metrics.span("y") and not metrics.recording()
    with metrics.record() as rec:
        with metrics.record() as inner:
            assert inner is rec and metrics.recording()
        m = metrics.RunMetrics(str(path))
        metrics.begin("setup")
        with metrics.span("a"):
            metrics.count("n", torch.tensor(3))
            metrics.count("n", torch.tensor([True, False, True, True]))
            metrics.count("n", 6)
        metrics.end("setup")
        metrics.end("never opened")
        m.segment(0, 10, 100, 1.0)
        m.segment(10, 20, 100, 1.0)
        with metrics.span("b"):
            pass
        m.summary()
        m.close()
    assert not metrics.recording()
    evs = events(path)
    assert [e["event"] for e in evs] == ["segment", "trace", "segment", "trace", "summary"]
    assert [n for n, _, _ in evs[1]["spans"]] == ["a", "setup"]
    assert evs[1]["counters"] == {"n": 12}
    assert evs[3] == {"event": "trace", "spans": [["b", *evs[3]["spans"][0][1:]]],
                      "counters": {}}
    assert not any('"trace"' in r.getMessage() for r in caplog.records)
    assert sum('"segment"' in r.getMessage() for r in caplog.records) == 2


def test_traced_step_launches_no_more_operations(complex_files):
    """The steps launch the same operators with a recorder active as
    without one: the counter keeps the step's own mask, whose sum waits for
    the segment's trace line."""
    _, setup, positions = complex_files
    sim = load_simulation(setup, positions[0], "dfire")
    runner = GsoTorchRunner(sim.batch_params(dtype=np.dtype("float64")), sim.positions,
                            sim.seed, sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                            dtype=torch.float64, device="cpu", energy_mode="kernel")
    ops, taken = [], None
    for traced in (False, True):
        runner.reset()
        with metrics.record() if traced else contextlib.nullcontext():
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                runner.run(STEPS)
            if traced:
                taken = metrics._active.take()
        ops.append(sorted(e.name for e in p.events() if e.name.startswith("aten::")))
    assert ops[0] and ops[0] == ops[1]
    spans, counters = taken
    assert [n for n, _, _ in spans] == ["energy", "move"] * STEPS
    assert counters == {"poses_scored": sum(independent_counts(setup, positions[0]))}
