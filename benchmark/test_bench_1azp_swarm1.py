"""The cell ``1azp-dna-anm.swarm1``: the 1azp DNA + 10 + 10 ANM deployment,
one swarm a job.  On the CPU at a small size, past the harness's look for
a card: sound, it is correct; the control in the program's place is not;
nor is a run with the receptor's coefficients zeroed in the energy, the
ANM part of the move skipped, or the move returning its state unchanged.
A traced run reports the ``anm_pose`` span's reader.  The readers of the
cell's own metrics (``anm_host_ms.step``, ``elec_kernel_ms.step``,
``elec_kernel_roofline_pct``) and ``ldbench.k3_work`` on synthetic runs.
On the card (``cuda``-marked; they skip without one) at the cell's own
size: sound, it is correct; the control is not.

    python -m pytest benchmark/test_bench_1azp_swarm1.py -q
"""

import json
import pathlib
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402
from ldbench import check, k3_work, manifest  # noqa: E402
from ldbench.devtrace import DeviceTrace, busy_intervals  # noqa: E402
from ldbench.record import RunRecord  # noqa: E402
from test_bench_card import card, lines  # noqa: E402,F401
from test_bench_faults import SMALL, one_thread  # noqa: E402,F401

CELL = "1azp-dna-anm.swarm1"
OVERRIDE = run.merge(SMALL, {
    "config": {"ligand_atoms": 90},
    "check": {"jobs": 3, "swarms": 1, "segments": 3, "score_snapshots": 2}})
K3 = "void (anonymous namespace)::elec_vdw_pairs_kernel<true>(EvInputs, int const*)"
K5 = "void (anonymous namespace)::elec_vdw_pairs_v1_kernel<true>(EvInputs, int const*)"
ROWS = "void (anonymous namespace)::sum_rows_kernel(float const*, int const*, float*)"
CULL = "void (anonymous namespace)::cull_bits_kernel((anonymous namespace)::Args)"


def run_cell(capsys, *extra, trace=0):
    code = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 5), "--seconds", "1",
                     "--trace", str(trace), "--platform", "cpu",
                     "--override", json.dumps(OVERRIDE), *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert code == 0
    return [json.loads(line) for line in out]


def test_sound_run_is_correct(capsys):
    result = run_cell(capsys)[-1]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"poses_per_s.swarm1", "job_s_p95", "setup_s"}
    assert result["checks"]["state_off_pct"]["limit"] == 20.0


def test_control_is_not_correct(capsys):
    """The reference in bfloat16 in the program's place, on three seeds."""
    limits = manifest.load("workloads", CELL)["limits"]
    for line in run_cell(capsys, "--readings", "3,4,5"):
        assert all(line["program"][k] <= limits[k] for k in check.NUMBERS), line
        assert any(line["control"][k] > limits[k] for k in check.NUMBERS), line


def receptor_modes_zeroed(monkeypatch):
    """The receptor's ANM coefficients zeroed in the energy the program
    scores with (the dense path ``auto`` takes on the CPU)."""
    from lightdock_tpu_torch.engine import runner

    original = runner.batch_energy_chunked

    def rigid_receptor(p, t, q, a_rec, a_lig, chunk, moved=None, prev_scoring=None):
        return original(p, t, q, torch.zeros_like(a_rec), a_lig, chunk)

    monkeypatch.setattr(runner, "batch_energy_chunked", rigid_receptor)


def anm_move_skipped(monkeypatch):
    """The GSO move keeps every glowworm's ANM coefficients."""
    from lightdock_tpu_torch.engine import gso

    original = gso.gso_move

    def no_anm(params, state, scoring, randoms):
        new, out = original(params, state, scoring, randoms)
        keep = {"a_rec": state.a_rec, "a_lig": state.a_lig}
        return new._replace(**keep), out._replace(**keep)

    monkeypatch.setattr(gso, "gso_move", no_anm)


def state_unchanged(monkeypatch):
    """The move returns the state it was given."""
    from lightdock_tpu_torch.engine import gso

    monkeypatch.setattr(gso, "gso_move",
                        lambda params, state, scoring, randoms: (state, gso.StepOutput(*state)))


@pytest.mark.parametrize("fault", [receptor_modes_zeroed, anm_move_skipped, state_unchanged],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cell(capsys)[-1]["correct"]


def test_traced_cpu_run_reports_the_anm_span(capsys):
    """A traced run on the CPU reports ``anm_host_ms.step.swarm1``; the K3
    readers, with no device trace there, report nothing."""
    got = run_cell(capsys, trace=1)[-1]["metrics"]
    assert got["anm_host_ms.step.swarm1"]["value"] > 0
    assert got["anm_host_ms.step.swarm1"]["value"] < got["energy_host_ms.step.swarm1"]["value"]
    assert "elec_kernel_ms.step.swarm1" not in got
    assert "elec_kernel_roofline_pct.swarm1" not in got


def synthetic(tmp_path, events, counters=({"poses_scored": 150},), spans=("anm_pose",),
              atoms=(4, 3)):
    """Two jobs of 10 steps, each a run's ``jobs/<k>`` beside a
    ``complex`` of ``atoms`` (receptor, ligand) atoms, each with one trace
    line a counter set, spans ``energy`` 10-40 and each of ``spans`` 15-25,
    on a device trace of ``events`` (None: no trace)."""
    (tmp_path / "complex").mkdir(parents=True)
    for name, n in zip(("rec", "lig"), atoms):
        lines_ = [f"ATOM  {i + 1:5d}  CA  ALA A   1       0.000   0.000   0.000"
                  for i in range(n)]
        (tmp_path / "complex" / f"lightdock_{name}.pdb").write_text("\n".join(lines_ + ["END"]))
    jobs = []
    for k in range(2):
        d = tmp_path / "jobs" / str(k)
        d.mkdir(parents=True)
        out = []
        for c in counters:
            out += [{"event": "segment", "seconds": 1.0},
                    {"event": "trace", "counters": c,
                     "spans": [["energy", 10, 40]] + [[s, 15, 25] for s in spans]}]
        (d / "metrics.jsonl").write_text("".join(json.dumps(x) + "\n" for x in out))
        jobs.append({"job": k, "dir": d, "ok": True, "t0": 0, "t1": 100, "steps": 10,
                     "poses": 100})
    dev = None if events is None else DeviceTrace(events, (0, 10 ** 9), 0,
                                                  busy_intervals(events, 0, 0, 10 ** 9))
    return RunRecord(jobs, 1.0, None, dev)


def test_anm_host_ms_reads_the_span(tmp_path):
    rec = synthetic(tmp_path, None)
    assert manifest.metric("anm_host_ms.step").read(rec) == pytest.approx(1e-6 * 2 * 10 / 20)
    assert manifest.metric("anm_host_ms.step.swarm1").read(rec) == pytest.approx(1e-6)
    assert manifest.metric("anm_host_ms.step").read(synthetic(tmp_path / "b", None,
                                                              spans=())) is None


def test_elec_kernel_ms_reads_k3_by_name(tmp_path):
    """K3 and its row sums over the 20 steps; K5, the cull and the ATen
    kernels are left out."""
    events = [(K3, 0, 3000), (ROWS, 3000, 3500), (K5, 4000, 9000), (CULL, 9000, 9100),
              ("void at::native::elementwise_kernel", 9100, 20000), (K3, 20000, 21500)]
    rec = synthetic(tmp_path, events)
    assert manifest.metric("elec_kernel_ms.step").read(rec) == pytest.approx(
        (3000 + 500 + 1500) * 1e-6 / 20)
    assert manifest.metric("elec_kernel_ms.step").read(synthetic(
        tmp_path / "b", [(K5, 0, 10), (CULL, 10, 20)])) is None
    assert manifest.metric("elec_kernel_ms.step").read(synthetic(tmp_path / "c", None)) is None


def test_k3_work_by_hand():
    """One pose of 1094 x 506 atoms in one call: 13 operations a pair;
    the pose's coordinates and the atoms' parameters, 12 bytes an atom
    each."""
    ops, nbytes = k3_work.work(1, 1094, 506, 1)
    assert ops == 1094 * 506 * 13 == 7_196_332
    assert nbytes == 2 * 1600 * 12 == 38_400
    assert k3_work.bound_s(ops, nbytes) == pytest.approx(max(7_196_332 / 67e12, 38_400 / 3.35e12))
    assert k3_work.bound_s(ops, nbytes) == pytest.approx(7_196_332 / 67e12)
    assert k3_work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_roofline_is_the_bound_over_the_device_time(tmp_path):
    """300 poses scored over 20 calls of 4 x 3 atoms, K3 busy 5,000 ns."""
    events = [(K3, 0, 4000), (ROWS, 4000, 5000), (CULL, 5000, 6000)]
    rec = synthetic(tmp_path, events)
    ops, nbytes = 300 * 12 * 13, (300 + 20) * 7 * 12
    want = 100 * max(ops / 67e12, nbytes / 3.35e12) / 5000e-9
    assert manifest.metric("elec_kernel_roofline_pct").read(rec) == pytest.approx(want)
    assert manifest.metric("elec_kernel_roofline_pct.swarm1").read(rec) == pytest.approx(want)
    assert 0 < want < 100
    # No counter, or no K3 kernel: nothing.
    assert manifest.metric("elec_kernel_roofline_pct").read(
        synthetic(tmp_path / "b", events, counters=({},))) is None
    assert manifest.metric("elec_kernel_roofline_pct").read(
        synthetic(tmp_path / "c", [(CULL, 0, 10)])) is None


@pytest.mark.cuda
def test_cell_is_correct_on_the_card(card, capsys):
    result = lines(capsys, CELL)[-1]
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card, capsys):
    limits = manifest.load("workloads", CELL)["limits"]
    for line in lines(capsys, CELL, "--readings", "21,22,23"):
        assert all(line["program"][k] <= limits[k] for k in check.NUMBERS), line
        assert any(line["control"][k] > limits[k] for k in check.NUMBERS), line
