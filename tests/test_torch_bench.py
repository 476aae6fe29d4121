"""The port's benchmark entry point (``lightdock_tpu_torch.bench``) and the
rule behind ``energy_mode='auto'`` (``engine.runner.pick_energy_mode``),
on the CPU: the rule at every point of the crossover map measured on an
H100 (``engine.runner.CROSSOVER_MAP``), and off the card against JAX's;
the bench's result line against ``bench.py``'s at a small size; its
runner against ``GsoJaxRunner`` built as ``bench.py`` builds it; the
crossover table's rows."""

import ast
import json
import logging
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _toy_system  # noqa: E402
from lightdock_tpu.engine import gso_jax  # noqa: E402
from lightdock_tpu_torch import bench, standin  # noqa: E402
from lightdock_tpu_torch.engine import runner as runner_module  # noqa: E402
from lightdock_tpu_torch.engine.runner import (CROSSOVER_MAP, CROSSOVER_TIE,  # noqa: E402
                                               GsoTorchRunner, pick_energy_mode)
from lightdock_tpu_torch.parallel.farm import SwarmFarmRunner  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the dense DFIRE steps run 12 times slower here on
    a full intra-op pool, and far slower beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shape(method, rec_anm, n_rec, n_lig, modes=10):
    """What the rule reads of a ``BatchScoringParams``."""
    return types.SimpleNamespace(
        method=method, use_anm=rec_anm, rec_nmodes=np.zeros((modes if rec_anm else 0, 0, 3)),
        rec_coords=np.zeros((n_rec, 3)), lig_coords=np.zeros((n_lig, 3)))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("point", CROSSOVER_MAP, ids=[f"{m[0]} x{m[5]}" for m in CROSSOVER_MAP])
def test_pick_energy_mode(point, device):
    """On the card, at every point of the measured map, a mode that lost
    by no more than the tie (1.2x, the spread between runs) in every run
    there, where either mode did; off it 'dense', as JAX's rule gives
    'xla' off a TPU.  No CUDA state is touched."""
    _, method, rec_anm, n_rec, n_lig, poses, lowest, highest = point
    shape = _shape(method, rec_anm, n_rec, n_lig)
    picked = pick_energy_mode(shape, device, poses)
    if device == "cpu":
        assert picked == "dense" and gso_jax.pick_energy_mode(shape) == "xla"
        return
    # each mode's worst loss over the runs
    holds = {"kernel": 1 / lowest <= CROSSOVER_TIE, "dense": highest <= CROSSOVER_TIE}
    assert holds[picked] or not any(holds.values())


def test_pick_energy_mode_reads_params():
    """The rule reads a built system's params: a receptor ANM counts where
    ``use_anm`` is set and the receptor has modes; a torch device too; the
    threshold is one of pairs times the poses of a call."""
    rigid, _, _ = standin.toy_system(8, 4, 2)
    anm, _, _ = standin.toy_system(8, 4, 2, num_anm=2)
    for params in (rigid, anm):
        assert pick_energy_mode(params, torch.device("cpu"), 200) == "dense"
        assert pick_energy_mode(params, "cuda:0", 200) == "dense"  # 32 pairs
    mid = _shape("dfire", True, 700, 100)  # 70k pairs, a receptor ANM: dense
    assert pick_energy_mode(mid, torch.device("cuda"), 200) == "dense"
    assert pick_energy_mode(mid, "cuda", 6400) == "kernel"  # a 32-swarm farm
    mid.use_anm = False  # rigid DFIRE is the kernel's from 60k pairs x 200
    assert pick_energy_mode(mid, "cuda", 200) == "kernel"
    assert pick_energy_mode(mid, "cuda", 100) == "dense"
    mid.use_anm, mid.rec_nmodes = True, np.zeros((0, 0, 3))  # no receptor modes: rigid
    assert pick_energy_mode(mid, "cuda", 200) == "kernel"
    mid.method = "pydock"
    assert pick_energy_mode(mid, "cuda", 200) == "dense"


def test_auto_goes_through_the_rule(monkeypatch, caplog):
    """The runner and the farm resolve 'auto' through ``pick_energy_mode``
    for their poses a call (G; S x G) and log the mode once; an explicit
    mode is never changed."""
    params, pos, _ = standin.toy_system(24, 16, 4)
    kw = dict(seed=1, use_anm=False, anm_rec=0, anm_lig=0, device="cpu")
    assert GsoTorchRunner(params, pos, energy_mode="auto", **kw).energy_mode == "dense"
    asked = []
    monkeypatch.setattr(runner_module, "pick_energy_mode",
                        lambda p, d, n: asked.append(n) or "kernel")
    with caplog.at_level(logging.INFO, "lightdock_tpu_torch.engine.runner"):
        one = GsoTorchRunner(params, pos, energy_mode="auto", **kw)
        farm = SwarmFarmRunner(params, [pos, pos, pos], [0, 1, 2], output_root=None, **kw)
    assert asked == [4, 12]
    assert one.energy_mode == farm.energy_mode == "kernel"
    assert one.energy_fn.kernel.__name__ == farm.energy_fn.kernel.__name__ == "dfire_pairs"
    assert [r.message for r in caplog.records] == [
        f"{who}: energy mode kernel (auto, {n} poses a call)"
        for who, n in (("GsoTorchRunner", 4), ("SwarmFarmRunner", 12))]
    monkeypatch.setattr(runner_module, "pick_energy_mode", lambda p, d, n: "dense")
    for mode in ("kernel", "kernel_v1"):
        steps, _, _ = standin.toy_system(24, 16, 4, dfire_mode="steps")
        assert GsoTorchRunner(steps, pos, energy_mode=mode, **kw).energy_mode == mode
    with pytest.raises(ValueError, match="make_energy takes"):
        runner_module.make_energy(params, "auto", "cpu", torch.float32)


def _bench_py_line():
    """The keys and the metric of the JSON object ``bench.py`` prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                return set(keys), node.values[keys.index("metric")].value
    raise AssertionError("bench.py prints no metric")


@pytest.fixture
def small(monkeypatch):
    """The bench at a small size: 64 x 16 atoms, 8 glowworms, 2 steps, 2
    repeats, a 2-swarm farm."""
    for name, value in dict(ATOMS_1PPE=(64, 16), ATOMS_1AZP=(64, 16), ANM_1AZP=2,
                            ATOMS_1K4C=(96, 64), GLOWWORMS=8, STEPS=2, REPEATS=2,
                            FARM_SWARMS=2, FARM_STEPS=2).items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.delenv("LIGHTDOCK_BENCH_MODE", raising=False)
    monkeypatch.delenv("LIGHTDOCK_BENCH_MULTISWARM", raising=False)
    monkeypatch.delenv("LIGHTDOCK_REFERENCE", raising=False)


@pytest.mark.parametrize("system", ["1ppe", "1azp", "1k4c"])
def test_bench_line(small, capsys, system):
    """The last line is ``bench.py``'s object with ``device``; the farm's
    aggregate goes to stderr with the default system only."""
    assert bench.main(["--device", "cpu", "--system", system]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys, metric = _bench_py_line()
    assert set(line) == keys | {"device"} and line["device"] == "cpu"
    assert line["metric"] == (metric if system == "1ppe" else bench.METRICS[system])
    assert line["value"] > 0 and line["unit"] == "poses/s"
    assert line["vs_baseline"] == round(line["value"] / bench.BASELINE_POSES_PER_S, 2)
    assert "energy mode: dense (requested auto)" in err
    assert ("multi-swarm aggregate: 2 swarms x 2 steps" in err) == (system == "1ppe")


def test_bench_needs_the_card(small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def test_bench_runner_matches_jax(small):
    """The bench's runner and ``GsoJaxRunner`` built as ``bench.py`` builds
    it, on the same stand-in: 'auto' resolves to 'dense' and 'xla', and
    the step-1 scores agree at float32."""
    params, pos, _, origin = bench.system("1ppe")
    jparams, jpos, _ = _toy_system(64, 16, 8)
    assert origin == "1ppe-shaped stand-in"
    np.testing.assert_array_equal(pos, jpos)
    ref = gso_jax.GsoJaxRunner(jparams, jpos, seed=324324, use_anm=False, anm_rec=0,
                               anm_lig=0, dtype=jnp.float32, energy_chunk=0,
                               energy_mode="auto")
    assert gso_jax.pick_energy_mode(jparams) == "xla" and ref._pallas_kernel is None
    ours = bench.make_runner(params, pos, 0, "auto", torch.device("cpu"))
    assert ours.energy_mode == "dense"
    np.testing.assert_allclose(ours.run(1)[1].scoring[0].numpy(),
                               np.asarray(ref.run(1)[1].scoring[0]), rtol=5e-5)


@pytest.mark.parametrize("budget,swarms", [(20.0, 1), (0.0, 2)])
def test_crossover_rows(small, monkeypatch, capsys, budget, swarms):
    """Each point's row, on one swarm or a farm: both modes timed over the
    same steps (fewer where the dense runs would pass the budget, and the
    line says so), the winner, its lead, and the rule's pick with what it
    lost by."""
    monkeypatch.setattr(bench, "CROSSOVER_POINTS", [("tiny", "dfire", 24, 16, 0),
                                                    ("tiny dna", "dna", 16, 8, 1)])
    monkeypatch.setattr(bench, "CROSSOVER_STEPS", 2)
    monkeypatch.setattr(bench, "CROSSOVER_WARMUP", 1)
    monkeypatch.setattr(bench, "CROSSOVER_REPEATS", 2)
    monkeypatch.setattr(bench, "CROSSOVER_DENSE_BUDGET_S", budget)
    assert bench.main(["--device", "cpu", "--crossover", "--swarms", str(swarms)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    table = json.loads(lines[-1])
    assert table["device"] == "cpu" and table["repeats"] == 2 and table["swarms"] == swarms
    assert [row["pairs"] for row in table["crossover"]] == [24 * 16, 16 * 8]
    assert lines[2].startswith("crossover: 2 points, 2 passes")
    for line, row in zip(lines, table["crossover"]):
        assert row["pick"] == "dense" and row["rec_anm"] == (row["method"] == "dna")
        assert row["poses"] == 8 * swarms and f"{8 * swarms} poses a call" in line
        assert row["steps"] == (2 if budget else 1)
        assert ("timed over 1 steps" in line) == (not budget)
        rate = {"kernel": row["kernel_poses_s"], "dense": row["dense_poses_s"]}
        assert row["winner"] == max(rate, key=rate.get)
        assert row["lead"] == pytest.approx(max(rate.values()) / min(rate.values()))
        assert row["pick_lost_by"] == pytest.approx(max(rate.values()) / rate["dense"])
