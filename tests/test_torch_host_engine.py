"""The port's float64 host parity engine (``engine.energy_host.HostScorer``,
``engine.gso_host.GsoHostEngine``, ``lightdock-tpu-torch --engine host``)
against the JAX package's on the CPU: the scorer at rtol 1e-12 for the
three methods (ANM on both sides, active restraints, a membrane, the
coincident-pair NaN and the clamp and slot edges), one movement phase bit
for bit, 20 steps of a toy DFIRE + ANM system, and the command line's
gso_1.out and gso_10.out byte for byte; each flag the host engine
refuses.  ``tests/test_torch_cuda.py`` holds the engine on the card
against the CPU."""

import contextlib
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu import constants as jc  # noqa: E402
from lightdock_tpu.cli import main as jax_main  # noqa: E402
from lightdock_tpu.engine import energy_host as jeh  # noqa: E402
from lightdock_tpu.engine.energy_batch import build_batch_params  # noqa: E402
from lightdock_tpu.engine.gso_host import GsoHostEngine as JaxHostEngine  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel as JaxModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu.simulation import load_simulation as jax_load_simulation  # noqa: E402
from lightdock_tpu_torch import cli, standin  # noqa: E402
from lightdock_tpu_torch.engine import energy_host as eh  # noqa: E402
from lightdock_tpu_torch.engine.gso_host import GsoHostEngine  # noqa: E402
from lightdock_tpu_torch.engine.params import from_reference  # noqa: E402
from lightdock_tpu_torch.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu_torch.simulation import load_simulation  # noqa: E402

CPU = "cpu"
N_REC, N_LIG, NUM_ANM = 80, 40, 2
CLI_G, CLI_STEPS = 20, "10"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _port_model(model) -> DockingModel:
    """The port's ``DockingModel`` with the fields of a JAX one."""
    return DockingModel(**{f.name: getattr(model, f.name)
                           for f in dataclasses.fields(DockingModel)})


def _toy_dfire_models(rng, n_rec=24, n_lig=18, num_anm=3):
    """``tests/test_gso_jax.py``'s toy DFIRE models."""
    def model(n):
        return JaxModel(
            method="dfire",
            coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=num_anm,
            nmodes=rng.standard_normal((num_anm, n, 3)) * 0.1,
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32),
        )
    return model(n_rec), model(n_lig)


def _random_positions(rng, g, anm_rec=0, anm_lig=0, spread=10.0):
    t = rng.uniform(-spread, spread, size=(g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cols = [t, q]
    if anm_rec:
        cols.append(rng.uniform(-1, 1, size=(g, anm_rec)))
    if anm_lig:
        cols.append(rng.uniform(-1, 1, size=(g, anm_lig)))
    return np.concatenate(cols, axis=1)


def _poses(rng, n, num_anm):
    """(translation, quaternion, receptor modes, ligand modes) rows, the
    identity pose first."""
    out = [(np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(num_anm), np.zeros(num_anm))]
    for _ in range(n - 1):
        q = rng.standard_normal(4)
        out.append((rng.uniform(-4, 4, 3), q / np.linalg.norm(q),
                    rng.uniform(-1, 1, num_anm), rng.uniform(-1, 1, num_anm)))
    return out


@pytest.fixture(scope="module")
def complexes(tmp_path_factory):
    """Per method: the JAX simulation of a ``standin.write_complex`` complex
    with NUM_ANM + NUM_ANM modes and an active restraint on each side, and
    its directory."""
    out = {}
    for method in ("dfire", "dna", "pydock"):
        root = tmp_path_factory.mktemp(method)
        setup, positions = standin.write_complex(root, method, N_REC, N_LIG, 4,
                                                 num_anm=NUM_ANM, seed=3)
        out[method] = (jax_load_simulation(setup, positions[0], method, anm_dir=root),
                       setup, positions[0], root)
    return out


@pytest.mark.parametrize("method", ["dfire", "dna", "pydock"])
def test_host_scorer_matches(complexes, method):
    """Twelve poses with ANM on both sides: the receptor's restraint
    residue, the ligand's and a membrane of the receptor atoms in the
    identity pose's interface, against JAX's scorer at rtol 1e-12."""
    sim = complexes[method][0]
    kw = {"potential": synthetic_potential()} if method == "dfire" else {}
    probe = jeh.HostScorer(method, sim.receptor, sim.ligand, True, **kw)
    rec, lig = probe.transformed_coordinates(np.zeros(3), np.array([1.0, 0, 0, 0]),
                                             np.zeros(NUM_ANM), np.zeros(NUM_ANM))
    d = np.sqrt(((rec[:, None] - lig[None]) ** 2).sum(-1))
    if method == "dfire":
        d = d * 2.0 - 1.0     # DFIRE's interface is on the scaled distance
    near = np.nonzero((d <= jc.INTERFACE_CUTOFF).any(axis=1))[0]
    assert near.size >= 1 and sim.receptor.active_restraints
    receptor = dataclasses.replace(sim.receptor, membrane=near.astype(np.int64))
    ref = jeh.HostScorer(method, receptor, sim.ligand, True, **kw)
    ours = eh.HostScorer(method, _port_model(receptor), _port_model(sim.ligand), True,
                         device=CPU, **kw)
    poses = _poses(np.random.RandomState(1), 12, NUM_ANM)
    got = np.array([ours.energy(*p) for p in poses])
    want = np.array([ref.energy(*p) for p in poses])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # The identity pose takes the membrane penalty.
    plain = jeh.HostScorer(method, dataclasses.replace(sim.receptor, active_restraints={}),
                           dataclasses.replace(sim.ligand, active_restraints={}), True, **kw)
    assert got[0] != plain.energy(*poses[0])


@pytest.mark.parametrize("method", ["dna", "pydock"])
def test_simulation_host_scorer_matches(complexes, method):
    """``Simulation.host_scorer`` on the same files (ANM on, as the setup
    says), against the JAX package's."""
    _, setup, positions, root = complexes[method]
    ours = load_simulation(setup, positions, method, anm_dir=root).host_scorer(device=CPU)
    ref = complexes[method][0].host_scorer()
    for p in _poses(np.random.RandomState(2), 6, NUM_ANM):
        assert ours.energy(*p) == pytest.approx(ref.energy(*p), rel=1e-12, abs=0)


def _pair_models(method, rec_coords, lig_coords, charges=(0.5, 0.5), types=(3, 7)):
    def model(coords, charge, atom_type):
        n = len(coords)
        kw = ({"atom_types": np.full(n, atom_type, dtype=np.int32)} if method == "dfire"
              else {"ele_charges": np.full(n, charge), "vdw_charges": np.full(n, 0.2),
                    "vdw_radii": np.full(n, 1.5)})
        return JaxModel(method=method, coordinates=np.asarray(coords, dtype=np.float64),
                        num_anm=0, nmodes=np.zeros((0, n, 3)),
                        membrane=np.zeros(0, dtype=np.int64), active_restraints={},
                        passive_restraints={}, **kw)
    return (model(rec_coords, charges[0], types[0]),
            model(lig_coords, charges[1], types[1]))


IDENTITY = (np.zeros(3), np.array([1.0, 0, 0, 0]), None, None)


@pytest.mark.parametrize("method", ["dna", "pydock"])
@pytest.mark.parametrize("case", ["near", "coincident", "zero_charge", "negative"])
def test_host_scorer_elec_vdw_edges(method, case):
    """``tests/test_energy.py``'s coincident-pair cases: at d = 1e-2 elec
    clamps to its maximum (to its minimum for opposite charges) and vdw to
    its cutoff; at d = 0 vdw is NaN through inf - inf (and elec 0/0 for an
    uncharged pair), and the NaN stays through both clamps."""
    d = 0.0 if case in ("coincident", "zero_charge") else 1e-2
    charges = {"zero_charge": (0.0, 0.5), "negative": (-0.5, 0.5)}.get(case, (0.5, 0.5))
    rec, lig = _pair_models(method, [[0.0, 0.0, 0.0]], [[d, 0.0, 0.0]], charges)
    ref = jeh.HostScorer(method, rec, lig, use_anm=False).energy(*IDENTITY)
    got = eh.HostScorer(method, _port_model(rec), _port_model(lig), use_anm=False,
                        device=CPU).energy(*IDENTITY)
    if d == 0.0:
        assert np.isnan(ref) and np.isnan(got)
    else:
        cut = jc.ELEC_MAX_CUTOFF if case == "near" else jc.ELEC_MIN_CUTOFF
        assert ref == -(cut * jc.FACTOR / jc.EPSILON + jc.VDW_CUTOFF)
        assert got == ref


def test_host_scorer_dfire_slot_edges():
    """DFIRE pairs from d = 0 (the scaled distance 2d - 1 negative: slot
    0) through the 0.5 A slot edges to the 15 A cutoff (the last slot) and
    past it, and across the interface on the scaled distance."""
    dists = [0.0, 0.2, 0.49, 0.5, 0.51, 1.0, 2.44, 2.45, 2.46, 7.3, 14.74,
             14.76, 14.99, 15.0, 15.01, 20.0]
    lig = [[x, 0.0, 0.0] for x in dists]
    pot = synthetic_potential()
    for rec_x in (0.0, 0.01):
        rec, lig_m = _pair_models("dfire", [[rec_x, 0.0, 0.0]], lig)
        ref = jeh.HostScorer("dfire", rec, lig_m, use_anm=False, potential=pot)
        ours = eh.HostScorer("dfire", _port_model(rec), _port_model(lig_m), use_anm=False,
                             potential=pot, device=CPU)
        assert ours.energy(*IDENTITY) == pytest.approx(ref.energy(*IDENTITY),
                                                       rel=1e-12, abs=0)


def test_bias_helpers_match():
    """The restraint fraction and the membrane share on random masks."""
    rng = np.random.RandomState(5)
    for _ in range(20):
        iface = rng.rand(30) < 0.3
        restraints = {f"A.ALA.{i}": list(rng.choice(30, rng.randint(0, 4), replace=False))
                      for i in range(rng.randint(0, 5))}
        membrane = rng.choice(30, rng.randint(0, 6), replace=False).astype(np.int64)
        assert eh.satisfied_restraints(iface, restraints) == \
            jeh.satisfied_restraints(iface, restraints)
        assert eh.membrane_intersection(iface, membrane) == \
            jeh.membrane_intersection(iface, membrane)


def _engines(seed, use_anm, g=64, spread=3.0):
    """Both engines on a toy DFIRE system; 10 + 10 modes with ANM (from
    eight terms on, NumPy's sum of squares pairs its terms)."""
    rng = np.random.RandomState(seed)
    num_anm = 10 if use_anm else 0
    rec, lig = _toy_dfire_models(rng, num_anm=num_anm)
    params = build_batch_params(rec, lig, use_anm=use_anm, potential=synthetic_potential())
    positions = _random_positions(rng, g, num_anm, num_anm, spread=spread)
    args = (positions, 324324 + seed, use_anm, num_anm, num_anm)
    return (JaxHostEngine(params, *args),
            GsoHostEngine(from_reference(params), *args, device=CPU), rng)


@pytest.mark.parametrize("use_anm", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_movement_phase_exact(use_anm, seed):
    """Both engines given the same state, luciferin and vision range move
    their glowworms bit for bit, over eight movement phases (the translation
    norm, the roulette's sums, slerp and the ANM steps all in the
    original's arithmetic)."""
    ref, ours, rng = _engines(seed, use_anm)
    for _ in range(8):
        lum = rng.uniform(4, 6, ours.num_glowworms)
        vision = rng.uniform(1, 5, ours.num_glowworms)
        for eng in (ref, ours):
            eng.luciferin, eng.vision = lum.copy(), vision.copy()
            eng.movement_phase()
        assert ours.moved.sum() > ours.num_glowworms // 2
        for name in ("t", "q", "a_rec", "a_lig", "vision", "num_neighbors", "moved"):
            assert np.array_equal(getattr(ours, name), getattr(ref, name)), name


def test_engine_matches_jax_host_engine_toy_dfire():
    """``tests/test_gso_jax.py``'s 20 steps of the toy DFIRE + ANM system
    at its tolerances, the neighbour counts exactly."""
    rng = np.random.RandomState(11)
    rec, lig = _toy_dfire_models(rng)
    params = build_batch_params(rec, lig, use_anm=True, potential=synthetic_potential())
    positions = _random_positions(rng, g=32, anm_rec=3, anm_lig=3)
    ref = JaxHostEngine(params, positions, seed=324324, use_anm=True, anm_rec=3, anm_lig=3)
    ref.run(20)
    ours = GsoHostEngine(from_reference(params), positions, seed=324324, use_anm=True,
                         anm_rec=3, anm_lig=3, device=CPU, energy_chunk=5)
    ours.run(20)
    assert np.array_equal(ours.num_neighbors, ref.num_neighbors)
    np.testing.assert_allclose(ours.t, ref.t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.q, ref.q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.luciferin, ref.luciferin, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(ours.vision, ref.vision, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.scoring, ref.scoring, rtol=1e-12, atol=1e-12)


def _cli_run(fn, root, name, argv):
    work = root / name
    work.mkdir()
    for f in root.glob("*.npy"):
        shutil.copy(f, work / f.name)
    with _cwd(work):
        assert fn([str(a) for a in argv]) == 0
    return work / "swarm_0"


@pytest.mark.parametrize("method,num_anm", [("dfire", 0), ("dna", NUM_ANM)])
def test_cli_host_matches_jax_cli(tmp_path, method, num_anm):
    """``lightdock-tpu-torch --engine host --platform cpu`` writes
    gso_1.out and gso_10.out byte for byte as ``lightdock-tpu --engine
    host``: DFIRE rigid, DNA with 2 + 2 ANM modes."""
    setup, positions = standin.write_complex(tmp_path, method, 60, 30, CLI_G,
                                             num_anm=num_anm, seed=7)
    argv = [setup, positions[0], CLI_STEPS, method, "--engine", "host"]
    ref = _cli_run(jax_main, tmp_path, "jax", argv)
    ours = _cli_run(cli.main, tmp_path, "torch", argv + ["--platform", "cpu"])
    for step in (1, 10):
        assert (ours / f"gso_{step}.out").read_bytes() == \
            (ref / f"gso_{step}.out").read_bytes(), step
    assert sorted(p.name for p in ours.iterdir()) == ["gso_1.out", "gso_10.out"]


REFUSED = {
    "a glob or list of positions files": ["--positions", "initial_positions_*.dat"],
    "--resume": ["--resume", "gso_10.out"],
    "--metrics": ["--metrics", "m.jsonl"],
    "--profile": ["--profile"],
    "--dq-bf16": ["--dq-bf16"],
    "--energy-chunk": ["--energy-chunk", "8"],
    "--jax-rng": ["--jax-rng"],
    "--dtype float32": ["--dtype", "float32"],
    "--energy-mode kernel": ["--energy-mode", "pallas"],
    "--energy-mode kernel_v1": ["--energy-mode", "kernel_v1"],
    "--steps-per-save": ["--steps-per-save", "5"],
}


@pytest.mark.parametrize("flag", list(REFUSED))
def test_cli_host_refuses(flag, capsys):
    """Each flag the host engine has no use for is refused by name, before
    any file is read or device sought."""
    extra = REFUSED[flag]
    positions = "initial_positions_0.dat"
    if extra[0] == "--positions":
        positions, extra = extra[1], []
    with pytest.raises(SystemExit) as exc:
        cli.main(["missing/setup.json", positions, "10", "dfire", "--engine", "host",
                  "--platform", "cpu", *extra])
    assert exc.value.code == 2
    assert f"--engine host does not take {flag}:" in capsys.readouterr().err


def test_cli_engine_names():
    """``torch`` is the default and JAX's ``jax`` is taken as it;
    ``--energy-mode dense`` and ``auto`` are the host engine's own."""
    base = ["setup.json", "initial_positions_0.dat", "10", "dna"]
    parser = cli.build_arg_parser()
    assert parser.parse_args(base).engine == "torch"
    assert parser.parse_args(base + ["--engine", "jax"]).engine == "torch"
    for mode in ("auto", "dense", "xla"):
        args = parser.parse_args(base + ["--engine", "host", "--energy-mode", mode,
                                         "--dtype", "float64"])
        assert args.engine == "host" and cli.host_refusals(args) == []

