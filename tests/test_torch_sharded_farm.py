"""The port's farm and command line across gloo ranks on the CPU, against
the one-process port and the JAX package, at float64.

The farm runs tests/test_farm.py's system (40 x 25 atoms, 2 + 2 ANM
modes, 16 glowworms, 3 swarms: 2 on rank 0 and 1 on rank 1); the command
line runs the 3-swarm glob of ``standin.write_complex`` files as
tests/test_torch_cli.py does.  Two spawns of 2 ranks run while this
process computes the references.  The ranks import this module, so JAX
and the JAX package are imported inside the tests only."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch import cli, standin  # noqa: E402
from lightdock_tpu_torch.parallel.farm import run_swarm_farm  # noqa: E402
from lightdock_tpu_torch.parallel.multihost import maybe_initialize_distributed  # noqa: E402
from lightdock_tpu_torch.utils.metrics import RunMetrics  # noqa: E402
from test_torch_sharded import RANK_TIMEOUT, spawn_in_thread  # noqa: E402

G, NUM_ANM, STEPS, SEED = 16, 2, 20, 324324
ANM = dict(use_anm=True, anm_rec=NUM_ANM, anm_lig=NUM_ANM)
SHARDED_STEPS = 10
CLI_STEPS = "10"


def _farm(params, positions, root, steps, **kw):
    run_swarm_farm(params, positions, list(range(len(positions))), SEED, steps,
                   dtype=torch.float64, output_root=str(root), device="cpu",
                   **ANM, **kw)


def farm_ranks(rank, params, positions, out):
    """Swarm-parallel farms (20 steps; 10 then resumed to 20, with
    metrics) and the 2-D farms with receptor atoms over both ranks."""
    torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", timeout=RANK_TIMEOUT)
    _farm(params, positions, out / "dp", STEPS, energy_mode="dense")
    _farm(params, positions, out / "resume", STEPS // 2, energy_mode="dense")
    metrics = RunMetrics(str(out / "metrics.jsonl") if rank == 0 else None)
    _farm(params, positions, out / "resume", STEPS, energy_mode="dense",
          resume=True, metrics=metrics)
    metrics.summary()
    metrics.close()
    for mode in ("kernel", "dense"):
        _farm(params, positions, out / f"2d_{mode}", SHARDED_STEPS,
              energy_mode=mode, n_atom_shards=2)


def cli_ranks(rank, argv, work):
    """``lightdock_tpu_torch.cli.main`` as under torchrun: the rank's
    environment is set, the command line initialises the process group."""
    torch.set_num_threads(1)
    os.chdir(work)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    (work / f"stdout{rank}.txt").write_text(out.getvalue())


# -- the tests ------------------------------------------------------------------

def _system():
    """tests/test_farm.py::_system (DFIRE, step tables), draw for draw."""
    from lightdock_tpu.engine.energy_batch import build_batch_params
    from lightdock_tpu.scoring.models import DockingModel
    from lightdock_tpu.scoring.potentials import synthetic_potential

    rng = np.random.RandomState(7)

    def model(n):
        return DockingModel(
            method="dfire", coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=NUM_ANM, nmodes=rng.standard_normal((NUM_ANM, n, 3)) * 0.1,
            membrane=np.zeros(0, dtype=np.int64), active_restraints={},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32))

    params = build_batch_params(model(40), model(25), use_anm=True,
                                potential=synthetic_potential(), dfire_mode="steps")

    def positions():
        pos = np.concatenate([
            rng.uniform(-5, 5, (G, 3)), rng.standard_normal((G, 4)),
            rng.uniform(-1, 1, (G, NUM_ANM)), rng.uniform(-1, 1, (G, NUM_ANM))],
            axis=1)
        pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
        return pos

    return params, [positions() for _ in range(3)]


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _work(root, name):
    work = root / name
    work.mkdir()
    for f in root.glob("*.npy"):
        shutil.copy(f, work / f.name)
    return work


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns and, meanwhile, the references: the one-process port
    farm, JAX's farms (swarm-parallel 'xla', 2-D 'pallas' in interpret mode
    and 'xla'), JAX's and the one-process port's command line."""
    import jax.numpy as jnp

    from lightdock_tpu.cli import main as jax_main
    from lightdock_tpu.parallel.farm import run_swarm_farm as jax_farm
    from lightdock_tpu_torch.engine.params import from_reference

    jparams, positions = _system()
    params = from_reference(jparams)
    farm_out = tmp_path_factory.mktemp("farm")
    wait_farm = spawn_in_thread(farm_ranks, 2, params, positions, farm_out)
    root = tmp_path_factory.mktemp("cli")
    setup, _ = standin.write_complex(root, "dfire", 60, 30, 10, n_swarms=3, seed=5)
    argv = [str(setup), str(root / "initial_positions_*.dat"), CLI_STEPS, "dfire",
            "--platform", "cpu"]
    ours = argv + ["--energy-mode", "kernel"]  # the port's v2 kernels (plain versions)
    cli_work = _work(root, "ranks")
    wait_cli = spawn_in_thread(cli_ranks, 2, ours + ["--metrics", str(cli_work / "m.jsonl")],
                               cli_work)

    ref = tmp_path_factory.mktemp("ref")
    _farm(params, positions, ref / "one", STEPS, energy_mode="dense")
    ids = [0, 1, 2]
    jax_farm(jparams, positions, ids, SEED, STEPS, dtype=jnp.float64,
             output_root=str(ref / "jax"), energy_mode="xla", **ANM)
    for mode in ("pallas", "xla"):
        jax_farm(jparams, positions, ids, SEED, SHARDED_STEPS, dtype=jnp.float64,
                 output_root=str(ref / f"jax_2d_{mode}"), energy_mode=mode,
                 n_atom_shards=2, **ANM)
    jax_cli, one_cli = _work(root, "jax"), _work(root, "one")
    with _cwd(jax_cli), contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(argv) == 0
    with _cwd(one_cli), contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(ours) == 0
    wait_farm()
    wait_cli()
    return dict(farm=farm_out, ref=ref, cli=cli_work, jax_cli=jax_cli, one_cli=one_cli)


def _text(root, sid, step):
    return (root / f"swarm_{sid}" / f"gso_{step}.out").read_text()


def test_swarm_parallel_farm_text_identical(runs):
    """2 ranks, 3 swarms (2 + 1): every gso_1, gso_10 and gso_20 is
    text-identical to the one-process port farm's and to JAX's farm's."""
    for sid in range(3):
        for step in (1, 10, 20):
            ours = _text(runs["farm"] / "dp", sid, step)
            assert ours == _text(runs["ref"] / "one", sid, step), (sid, step)
            assert ours == _text(runs["ref"] / "jax", sid, step), (sid, step)


def test_swarm_parallel_resume_and_metrics(runs):
    """2 ranks resumed from step 10 (each reads every swarm's sidecars)
    write the uninterrupted run's gso_20; rank 0 alone writes the
    metrics, counting all 3 swarms."""
    for sid in range(3):
        assert (_text(runs["farm"] / "resume", sid, 20)
                == _text(runs["ref"] / "one", sid, 20)), sid
    events = [json.loads(x) for x in (runs["farm"] / "metrics.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["segment", "summary"]
    assert events[0]["poses"] == 3 * G * (STEPS // 2)
    assert events[-1]["total_poses_scored"] == 3 * G * (STEPS // 2)


@pytest.mark.parametrize("mode,jax_mode", [("kernel", "pallas"), ("dense", "xla")])
def test_atom_sharded_farm_matches_jax(runs, mode, jax_mode):
    """run_swarm_farm(n_atom_shards=2) on 2 ranks against JAX's
    run_swarm_farm(n_atom_shards=2) on a (3, 2) mesh: the sidecars of
    gso_1 and gso_10 at 1e-9, the neighbour counts exactly; one rank
    wrote each swarm."""
    for sid in range(3):
        for step in (1, SHARDED_STEPS):
            name = f"swarm_{sid}/gso_{step}.out.npz"
            with np.load(runs["farm"] / f"2d_{mode}" / name) as ours, \
                    np.load(runs["ref"] / f"jax_2d_{jax_mode}" / name) as ref:
                for k in ("t", "q", "a_rec", "a_lig", "luciferin", "vision", "scoring"):
                    np.testing.assert_allclose(ours[k], ref[k], rtol=1e-9, atol=1e-9,
                                               err_msg=f"{name} {k}")
                np.testing.assert_array_equal(ours["num_neighbors"], ref["num_neighbors"])


def test_cli_glob_under_two_ranks_matches_jax_cli(runs):
    """``lightdock_tpu_torch.cli.main`` on 2 ranks (torchrun's environment,
    ``--platform cpu``: gloo) writes gso_1 and gso_10 of the 3-swarm glob
    text-identical to ``lightdock_tpu.cli`` and to one process; each rank
    says which swarms it runs; rank 0's metrics count all 3 swarms."""
    for sid in range(3):
        for step in (1, 10):
            ours = _text(runs["cli"], sid, step)
            assert ours == _text(runs["jax_cli"], sid, step), (sid, step)
            assert ours == _text(runs["one_cli"], sid, step), (sid, step)
    said = [(runs["cli"] / f"stdout{r}.txt").read_text() for r in range(2)]
    assert "on 2 device(s) [cpu]" in said[0]
    assert "Rank 0 of 2 (gloo) on cpu: 2 swarms, ids 0, 1" in said[0]
    assert "Rank 1 of 2 (gloo) on cpu: 1 swarms, ids 2" in said[1]
    summary = json.loads((runs["cli"] / "m.jsonl").read_text().splitlines()[-1])
    assert summary["total_poses_scored"] == 3 * 10 * int(CLI_STEPS)


def test_atom_sharding_refuses_kernel_v1(tmp_path):
    """As JAX's refuses 'pallas_v1': the v1 kernels do not compose with
    receptor-atom sharding."""
    params, positions = _system()
    from lightdock_tpu_torch.engine.params import from_reference
    with pytest.raises(ValueError, match="v2 kernels"):
        _farm(from_reference(params), positions, tmp_path, 2,
              energy_mode="kernel_v1", n_atom_shards=2)


def test_atom_sharding_needs_ranks(tmp_path):
    """One process cannot split the receptor over 2 ranks: the mesh says so
    rather than running unsharded."""
    params, positions = _system()
    from lightdock_tpu_torch.engine.params import from_reference
    with pytest.raises(ValueError, match="mesh over 1 ranks"):
        _farm(from_reference(params), positions, tmp_path, 2,
              energy_mode="kernel", n_atom_shards=2)
