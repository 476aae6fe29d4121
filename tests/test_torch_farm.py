"""The port's multi-swarm farm (``lightdock_tpu_torch.parallel.farm``) on
the CPU: each swarm equals a single-swarm run, the snapshots equal the JAX
farm's, the kernel modes match JAX's Pallas farms, resume is bit-exact.
The system is tests/test_farm.py's (40 x 25 atoms, 16 glowworms, 2 + 2
ANM modes)."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu.engine.energy_batch import build_batch_params  # noqa: E402
from lightdock_tpu.parallel.farm import SwarmFarmRunner as JaxFarm  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu_torch.engine.params import from_reference  # noqa: E402
from lightdock_tpu_torch.engine.runner import GsoTorchRunner  # noqa: E402
from lightdock_tpu_torch.parallel.farm import (  # noqa: E402
    SwarmFarmRunner, run_swarm_farm)

G, NUM_ANM = 16, 2
ANM = dict(use_anm=True, anm_rec=NUM_ANM, anm_lig=NUM_ANM)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(method="dfire", n_rec=40, n_lig=25, seed=7, n_swarms=3):
    """tests/test_farm.py::_system, draw for draw."""
    rng = np.random.RandomState(seed)

    def model(n):
        kw = {}
        if method == "dfire":
            kw["atom_types"] = rng.randint(0, 168, size=n).astype(np.int32)
        else:
            kw.update(ele_charges=rng.uniform(-1, 1, n),
                      vdw_charges=rng.uniform(0, 0.5, n),
                      vdw_radii=rng.uniform(0.5, 2.5, n))
        return DockingModel(
            method=method,
            coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=NUM_ANM,
            nmodes=rng.standard_normal((NUM_ANM, n, 3)) * 0.1,
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={}, passive_restraints={}, **kw)

    params = build_batch_params(
        model(n_rec), model(n_lig), use_anm=True,
        potential=synthetic_potential() if method == "dfire" else None,
        dfire_mode="steps" if method == "dfire" else "gather")

    def positions():
        pos = np.concatenate([
            rng.uniform(-5, 5, (G, 3)), rng.standard_normal((G, 4)),
            rng.uniform(-1, 1, (G, NUM_ANM)), rng.uniform(-1, 1, (G, NUM_ANM))],
            axis=1)
        pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
        return pos

    return params, [positions() for _ in range(n_swarms)]


def _farm(params, positions_list, root, mode="dense", ids=None, **kw):
    ids = list(range(len(positions_list))) if ids is None else ids
    return SwarmFarmRunner(from_reference(params), positions_list, ids,
                           seed=324324, dtype=torch.float64, device="cpu",
                           output_root=None if root is None else str(root),
                           energy_mode=mode, **ANM, **kw)


def _text(root, sid, step):
    return (root / f"swarm_{sid}" / f"gso_{step}.out").read_text()


@pytest.mark.parametrize("mode", ["dense", "kernel"])
def test_farm_matches_single_swarm_runs(tmp_path, mode):
    """f64: every swarm of the farm writes the snapshots of a single-swarm
    GsoTorchRunner run from the same positions, byte for byte."""
    params, positions_list = _system()
    farm = _farm(params, positions_list, tmp_path / "farm", mode)
    farm.run_segmented(20, segment=10)
    for i, pos in enumerate(positions_list):
        single = GsoTorchRunner(from_reference(params), pos, seed=324324,
                                output_directory=str(tmp_path / f"single_{i}"),
                                dtype=torch.float64, device="cpu",
                                energy_mode=mode, **ANM)
        single.run(20)
        for step in (1, 10, 20):
            assert (_text(tmp_path / "farm", i, step)
                    == (tmp_path / f"single_{i}" / f"gso_{step}.out").read_text()), (i, step)


def test_farm_matches_jax_farm_text(tmp_path):
    """f64: gso_1, gso_10 and gso_20 of every swarm text-identical to the
    JAX farm's on the XLA path."""
    params, positions_list = _system()
    ref = JaxFarm(params, positions_list, [0, 1, 2], seed=324324,
                  dtype=jnp.float64, output_root=str(tmp_path / "jax"),
                  energy_mode="xla", **ANM)
    ref.run_segmented(20, segment=10)
    _farm(params, positions_list, tmp_path / "torch").run_segmented(20, segment=10)
    for i in range(3):
        for step in (1, 10, 20):
            assert _text(tmp_path / "jax", i, step) == _text(tmp_path / "torch", i, step)
            assert (tmp_path / "torch" / f"swarm_{i}" / f"gso_{step}.out.npz").exists()


@pytest.mark.parametrize("method", ["dfire", "dna"])
@pytest.mark.parametrize("mode,jax_mode", [("kernel", "pallas"), ("kernel_v1", "pallas_v1")])
def test_farm_kernel_modes_match_jax_pallas(method, mode, jax_mode):
    """The kernel modes (plain versions on the CPU) against JAX's Pallas
    farms in interpret mode, with test_farm_pallas_matches_xla's
    tolerances: the same selections, f64-close states."""
    params, positions_list = _system(method=method, n_swarms=2)
    ref = JaxFarm(params, positions_list, [0, 1], seed=324324, dtype=jnp.float64,
                  output_root=None, energy_mode=jax_mode, interpret=True, **ANM)
    ref.run_segmented(10, segment=10)
    farm = _farm(params, positions_list, None, mode)
    farm.run_segmented(10, segment=10)
    ours = farm.states
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.states.t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.scoring.numpy(), np.asarray(ref.states.scoring),
                               rtol=1e-9, atol=1e-9)
    assert np.array_equal(ours.num_neighbors.numpy(), np.asarray(ref.states.num_neighbors))


def test_farm_resume_bit_exact(tmp_path):
    """Ten steps, then a fresh runner resumes: gso_20 byte-identical to the
    uninterrupted farm's, and the final states equal."""
    params, positions_list = _system(n_swarms=2)
    full = _farm(params, positions_list, tmp_path / "full")
    full.run_segmented(20, segment=10)
    _farm(params, positions_list, tmp_path / "part").run_segmented(10, segment=10)
    cont = _farm(params, positions_list, tmp_path / "part")
    assert cont.resume_latest() == 10
    cont.run_segmented(20, segment=10)
    for a, b in zip(cont.states, full.states):
        assert torch.equal(a, b)
    for i in (0, 1):
        assert _text(tmp_path / "full", i, 20) == _text(tmp_path / "part", i, 20)


def test_farm_resume_survives_missing_sidecar(tmp_path, caplog):
    """A swarm that lost its newest sidecar: the farm resumes at the
    lockstep minimum and warns that the others were ahead; the final
    snapshots still match the uninterrupted run.  A swarm with no sidecar
    at all restarts every swarm from step 0, loudly."""
    params, positions_list = _system(n_swarms=2)
    _farm(params, positions_list, tmp_path / "full").run_segmented(20, segment=10)
    _farm(params, positions_list, tmp_path / "part").run_segmented(20, segment=10)
    (tmp_path / "part" / "swarm_1" / "gso_20.out.npz").unlink()
    cont = _farm(params, positions_list, tmp_path / "part")
    with caplog.at_level(logging.WARNING, "lightdock_tpu_torch.parallel.farm"):
        assert cont.resume_latest() == 10
    assert any("were ahead" in r.message for r in caplog.records)
    cont.run_segmented(20, segment=10)
    for i in (0, 1):
        assert _text(tmp_path / "full", i, 20) == _text(tmp_path / "part", i, 20)
    for p in (tmp_path / "part" / "swarm_0").glob("*.npz"):
        p.unlink()
    cold = _farm(params, positions_list, tmp_path / "part")
    with caplog.at_level(logging.WARNING, "lightdock_tpu_torch.parallel.farm"):
        assert cold.resume_latest() == 0
    assert any("restarting ALL" in r.message for r in caplog.records)


def test_run_swarm_farm_entry(tmp_path, monkeypatch):
    """run_swarm_farm writes every swarm's directory (and only those),
    refuses receptor-atom sharding in one process (it needs a rank for each
    shard; tests/test_torch_sharded_farm.py runs it on ranks), and runs on
    the card unless asked for the CPU."""
    params, positions_list = _system(n_swarms=2)
    kw = dict(seed=1, steps=10, dtype=torch.float64, **ANM)
    run_swarm_farm(from_reference(params), positions_list, [0, 9],
                   output_root=str(tmp_path), device="cpu", **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["swarm_0", "swarm_9"]
    assert (tmp_path / "swarm_9" / "gso_10.out").exists()
    with pytest.raises(ValueError, match="mesh over 1 ranks"):
        run_swarm_farm(from_reference(params), positions_list, [0, 1],
                       output_root=str(tmp_path), n_atom_shards=2, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SwarmFarmRunner(from_reference(params), positions_list, [0, 1], seed=1, **ANM)


def test_farm_cull_off_matches_cull_on_and_jax(tmp_path):
    """f64, a 2-swarm farm in the kernel mode: ``cull=False`` reaches the
    energy function (a pose 100 A out keeps every tile bit) and writes
    gso_1.out and gso_10.out of every swarm text-identical to
    ``cull=True`` and to the JAX farm's Pallas path with ``cull=False``."""
    params, positions_list = _system(n_swarms=2)
    ref = JaxFarm(params, positions_list, [0, 1], seed=324324, dtype=jnp.float64,
                  output_root=str(tmp_path / "jax"), energy_mode="pallas",
                  cull=False, interpret=True, **ANM)
    ref.run_segmented(10, segment=10)
    far = torch.tensor([[100.0, 0.0, 0.0]], dtype=torch.float64)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    a = torch.zeros((1, NUM_ANM), dtype=torch.float64)
    for cull in (True, False):
        farm = _farm(params, positions_list, tmp_path / f"cull_{cull}", "kernel",
                     cull=cull)
        args, _ = farm.energy_fn.kernel_args(farm.params, far, q, a, a)
        assert bool(args[3].all()) == (not cull)
        farm.run_segmented(10, segment=10)
    for i in (0, 1):
        for step in (1, 10):
            off = _text(tmp_path / "cull_False", i, step)
            assert off == _text(tmp_path / "cull_True", i, step), (i, step)
            assert off == _text(tmp_path / "jax", i, step), (i, step)
