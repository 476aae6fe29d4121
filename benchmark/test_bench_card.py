"""The benchmark's cells on the card (``cuda``-marked; they skip without
one), each at its own size with a short window: sound, it is correct; the
control in the program's place on three seeds is not; nor is a run with
the timed path broken underneath, where the cells run it: half of the
batch left out of the kernel energy function (the mean of the rest in its
place), and a GSO step (the farm's, or the one-swarm runner's move) that
returns its state unchanged.  The example DNA + ANM cell (``examples/``),
added as new files to a copy of the benchmark, at the 1azp size: sound, it
is correct; the control on three seeds is not.

    python -m pytest --noconftest -m cuda benchmark/test_bench_card.py -q
"""

import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import run  # noqa: E402
from examples.add import copy_with  # noqa: E402
from ldbench import check, manifest  # noqa: E402

CELLS = ["1k4c-dfire-membrane.glob32", "1ppe-dfire-rigid.swarm1"]
EXAMPLE = HERE / "examples" / "1azp-dna-anm.glob32.json"
EXAMPLE_CELLS = ["1azp-dna-anm.glob32"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def lines(capsys, cell, *extra):
    code = run.main(["--workload", cell, "--seed", str(2 ** 31 + 17), "--seconds", "2",
                     "--trace", "0", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert code == 0
    for line in out:
        print(line, file=sys.stderr)   # the readings, shown with -rA
    return [json.loads(line) for line in out]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(card, capsys, cell):
    result = lines(capsys, cell)[-1]
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, capsys, cell):
    limits = manifest.load("workloads", cell)["limits"]
    for line in lines(capsys, cell, "--readings", "21,22,23"):
        assert all(line["program"][k] <= limits[k] for k in check.NUMBERS), line
        assert any(line["control"][k] > limits[k] for k in check.NUMBERS), line


@pytest.fixture
def example(monkeypatch, tmp_path):
    """The harness reads a copy of the benchmark with the example added."""
    copy = copy_with(EXAMPLE, tmp_path / "bench")
    monkeypatch.setattr(manifest, "HERE", copy / "benchmark")
    monkeypatch.setattr(manifest, "BENCHMARK", copy / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", EXAMPLE_CELLS)
def test_example_cell_is_correct(card, example, capsys, cell):
    result = lines(capsys, cell)[-1]
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", EXAMPLE_CELLS)
def test_example_control_is_not_correct(card, example, capsys, cell):
    limits = manifest.load("workloads", cell)["limits"]
    for line in lines(capsys, cell, "--readings", "21,22,23"):
        assert all(line["program"][k] <= limits[k] for k in check.NUMBERS), line
        assert any(line["control"][k] > limits[k] for k in check.NUMBERS), line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_in_the_kernel_energy_is_not_correct(card, capsys, monkeypatch, cell):
    import torch

    from lightdock_tpu_torch.engine import runner

    original = runner.make_kernel_energy_fn
    calls = []

    def make(*args, **kwargs):
        fn = original(*args, **kwargs)

        def half(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None):
            calls.append(t.shape[0])
            scores = fn(p, t, q, a_rec, a_lig, moved=moved, prev_scoring=prev_scoring)
            n = scores.shape[0] // 2
            return torch.cat([scores[:n], scores[:n].mean().expand(scores.shape[0] - n)])

        half.kernel = fn.kernel
        return half

    monkeypatch.setattr(runner, "make_kernel_energy_fn", make)
    assert not lines(capsys, cell)[-1]["correct"]
    traffic = manifest.cell(cell)["traffic"]
    assert calls and set(calls) == {traffic["swarms"] * 200}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_is_not_correct(card, capsys, monkeypatch, cell):
    from lightdock_tpu_torch.engine import gso
    from lightdock_tpu_torch.parallel import farm

    calls = []
    if manifest.cell(cell)["traffic"]["glob"]:
        def unchanged(params, states, randoms, energy_fn):
            calls.append(1)
            return states, gso.StepOutput(*states)

        monkeypatch.setattr(farm, "swarms_step", unchanged)
    else:
        def unchanged(params, state, scoring, randoms):
            calls.append(1)
            return state, gso.StepOutput(*state)

        monkeypatch.setattr(gso, "gso_move", unchanged)
    assert not lines(capsys, cell)[-1]["correct"]
    assert calls
