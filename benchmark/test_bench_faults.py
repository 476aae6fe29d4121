"""A whole run of a cell on the CPU at a small size, past the harness's look
for a card: sound, it is correct; with the control in the program's place,
or with the timed path broken underneath, it is not.

The faults a one-card cell of this benchmark can have: a step that returns
its state unchanged; half of the batch of poses left out of the energy,
the mean of the rest in its place; an answer altered where it is written;
a snapshot left out; and where the cell has ANM modes, the receptor's
coefficients zeroed in the energy the program scores with, and the ANM
part of the move skipped.  At these sizes the program's ``auto`` mode
scores on the dense path; ``test_bench_card.py`` plants the first two on
the kernel path at the cells' own sizes.

Beside the cells of ``BENCHMARK.json``, the example DNA + ANM cell
(``examples/``) runs here from a copy of the benchmark to which it is
added as new files, as a later change would add it.

    python -m pytest benchmark/test_bench_faults.py -q
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
from examples.add import copy_with  # noqa: E402
from ldbench import check, manifest  # noqa: E402

SMALL = {"config": {"receptor_atoms": 300, "ligand_atoms": 60, "glowworms": 30, "steps": 20},
         "min_job_s": 0.3}
CELLS = {
    "1k4c-dfire-membrane.glob32": {
        "config": {"membrane": {"beads": 40}, "swarm_centres": 3},
        "traffic": {"swarms": 3},
        "check": {"jobs": 2, "swarms": 3, "segments": 3, "score_snapshots": 2}},
    "1ppe-dfire-rigid.swarm1": {
        "check": {"jobs": 3, "swarms": 1, "segments": 3, "score_snapshots": 2}},
    "1azp-dna-anm.glob32": {
        "config": {"ligand_atoms": 90, "swarm_centres": 3},
        "traffic": {"swarms": 3},
        "check": {"jobs": 2, "swarms": 3, "segments": 3, "score_snapshots": 2}},
}
EXAMPLES = {"1azp-dna-anm.glob32": HERE / "examples" / "1azp-dna-anm.glob32.json"}
ANM_CELLS = ["1azp-dna-anm.glob32"]


@pytest.fixture(autouse=True)
def example_cell(request, monkeypatch, tmp_path):
    """Where the test's cell is an example, the harness reads a copy of the
    benchmark with the example added."""
    callspec = getattr(request.node, "callspec", None)
    cell = callspec.params.get("cell") if callspec else None
    if cell in EXAMPLES:
        copy = copy_with(EXAMPLES[cell], tmp_path / "bench")
        monkeypatch.setattr(manifest, "HERE", copy / "benchmark")
        monkeypatch.setattr(manifest, "BENCHMARK", copy / "BENCHMARK.json")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(capsys, cell, *extra):
    override = run.merge(SMALL, CELLS[cell])
    code = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds", "1",
                     "--trace", "0", "--platform", "cpu", "--override", json.dumps(override),
                     *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert code == 0
    return [json.loads(line) for line in lines]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell):
    result = run_cell(capsys, cell)[-1]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == set(manifest.cell(cell)["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(capsys, cell):
    """The reference in bfloat16 in the program's place, on three seeds."""
    limits = manifest.load("workloads", cell)["limits"]
    for line in run_cell(capsys, cell, "--readings", "3,4,5"):
        assert all(line["program"][k] <= limits[k] for k in check.NUMBERS), line
        assert any(line["control"][k] > limits[k] for k in check.NUMBERS), line


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_is_not_correct(capsys, monkeypatch, cell):
    from lightdock_tpu_torch.engine import gso

    monkeypatch.setattr(gso, "gso_move",
                        lambda params, state, scoring, randoms: (state, gso.StepOutput(*state)))
    assert not run_cell(capsys, cell)[-1]["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_not_correct(capsys, monkeypatch, cell):
    from lightdock_tpu_torch.engine import runner

    original = runner.batch_energy_chunked

    def half(p, t, q, a_rec, a_lig, chunk, moved=None, prev_scoring=None):
        scores = original(p, t, q, a_rec, a_lig, chunk)
        n = scores.shape[0] // 2
        return torch.cat([scores[:n], scores[:n].mean().expand(scores.shape[0] - n)])

    monkeypatch.setattr(runner, "batch_energy_chunked", half)
    assert not run_cell(capsys, cell)[-1]["correct"]


def writers():
    """The snapshot writer as the farm and the one-swarm runner bind it."""
    from lightdock_tpu_torch.engine import runner
    from lightdock_tpu_torch.parallel import multihost

    return multihost, runner


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(capsys, monkeypatch, cell):
    for module in writers():
        original = module.write_gso_output

        def altered(path, poses, luciferin, num_neighbors, vision, scoring, original=original):
            scoring = scoring.copy()
            scoring[0] += 0.5
            original(path, poses, luciferin, num_neighbors, vision, scoring)

        monkeypatch.setattr(module, "write_gso_output", altered)
    assert not run_cell(capsys, cell)[-1]["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_missing_output_fails_the_job(capsys, monkeypatch, cell):
    for module in writers():
        original = module.write_gso_output

        def skip_step_10(path, *args, original=original):
            if pathlib.Path(path).name != "gso_10.out":
                original(path, *args)

        monkeypatch.setattr(module, "write_gso_output", skip_step_10)
    result = run_cell(capsys, cell)[-1]
    assert not result["correct"] and result["failed"] == result["attempted"] >= 1


@pytest.mark.parametrize("cell", ANM_CELLS)
def test_receptor_modes_left_out_is_not_correct(capsys, monkeypatch, cell):
    """The receptor's ANM coefficients zeroed in the energy the program
    scores with."""
    from lightdock_tpu_torch.engine import runner

    original = runner.batch_energy_chunked

    def rigid_receptor(p, t, q, a_rec, a_lig, chunk, moved=None, prev_scoring=None):
        return original(p, t, q, torch.zeros_like(a_rec), a_lig, chunk)

    monkeypatch.setattr(runner, "batch_energy_chunked", rigid_receptor)
    assert not run_cell(capsys, cell)[-1]["correct"]


@pytest.mark.parametrize("cell", ANM_CELLS)
def test_anm_move_skipped_is_not_correct(capsys, monkeypatch, cell):
    """The GSO move keeps every glowworm's ANM coefficients."""
    from lightdock_tpu_torch.engine import gso

    original = gso.gso_move

    def no_anm(params, state, scoring, randoms):
        new, out = original(params, state, scoring, randoms)
        keep = {"a_rec": state.a_rec, "a_lig": state.a_lig}
        return new._replace(**keep), out._replace(**keep)

    monkeypatch.setattr(gso, "gso_move", no_anm)
    assert not run_cell(capsys, cell)[-1]["correct"]
