"""The port's setup stage (``lightdock_tpu_torch.setup_sim``,
``cli_tools``) against the JAX package's on the same raw PDB files, on the
CPU: every file ``run_setup`` writes byte for byte (rigid, with ANM, with
``noh``), the sampler's pieces bit for bit, and ``flatten``'s ``.npy``
(``ReferenceRng`` is held to the JAX package's in
``tests/test_torch_host.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu import cli_tools as jcli_tools  # noqa: E402
from lightdock_tpu import setup_sim as jsetup  # noqa: E402
from lightdock_tpu.utils import rng as jrng  # noqa: E402
from lightdock_tpu_torch import cli_tools, setup_sim, standin  # noqa: E402
from lightdock_tpu_torch.utils import rng as trng  # noqa: E402

N_REC, N_LIG = 90, 35

# Records the filters act on: hydrogens by element and by name (with no
# element, and a digit-led name), OXT, water, and records that are kept
# (TER, MODEL/ENDMDL, END) or dropped (REMARK, CONECT).
EXTRA = (
    "REMARK  a raw file\n"
    "MODEL        1\n"
    "{atoms}"
    "ATOM   9001  H   ALA A 900      1.000   2.000   3.000  1.00  0.00           H\n"
    "ATOM   9002  HA  ALA A 900      1.500   2.000   3.000\n"
    "ATOM   9003 1HB  ALA A 900      2.000   2.000   3.000\n"
    "ATOM   9004  OXT ALA A 900      2.500   2.000   3.000  1.00  0.00           O\n"
    "HETATM 9005  O   HOH W   1      3.000   2.000   3.000  1.00  0.00           O\n"
    "HETATM 9006 ZN    ZN Z   1      3.500   2.000   3.000  1.00  0.00          ZN\n"
    "TER\n"
    "CONECT 9005 9006\n"
    "ENDMDL\n"
    "END\n")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw receptor and ligand PDB files from ``standin.write_complex``,
    with the records the filters act on added."""
    root = tmp_path_factory.mktemp("raw")
    standin.write_complex(root / "src", "dfire", N_REC, N_LIG, 2, seed=11)
    for side in ("rec", "lig"):
        atoms = [ln + "\n" for ln in (root / "src" / f"lightdock_{side}.pdb").read_text()
                 .splitlines() if ln.startswith("ATOM")]
        (root / f"{side}.pdb").write_text(EXTRA.format(atoms="".join(atoms)))
    return root


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kwargs", [
    {},
    {"use_anm": True, "anm_rec": 10, "anm_lig": 10, "swarms": 3},
    {"noh": True, "use_anm": True, "anm_rec": 3, "anm_lig": 0, "starting_points_seed": 7},
], ids=["rigid", "anm", "noh"])
def test_run_setup_matches(raw, tmp_path, kwargs):
    """setup.json, every init/initial_positions_N.dat and both
    lightdock_*.pdb working copies are byte-identical."""
    base = {"receptor_pdb": str(raw / "rec.pdb"), "ligand_pdb": str(raw / "lig.pdb"),
            "swarms": 5, "glowworms": 30, **kwargs}
    ours = setup_sim.run_setup(setup_sim.SetupConfig(**base), tmp_path / "port")
    ref = jsetup.run_setup(jsetup.SetupConfig(**base), tmp_path / "jax")
    assert ours == ref
    a, b = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(a) == sorted(b)
    assert len([k for k in a if k.startswith("init/")]) == base["swarms"]
    assert a == b
    kept = (tmp_path / "port" / "lightdock_rec.pdb").read_text()
    assert ("HOH" not in kept and "OXT" not in kept and "ZN" in kept
            and ("1HB" in kept) != bool(kwargs.get("noh")))


def test_setup_pieces_match(raw):
    """The Fibonacci directions, the swarm centres and one swarm's
    glowworms with ANM coefficients, bit for bit."""
    np.testing.assert_array_equal(setup_sim.fibonacci_directions(37),
                                  jsetup.fibonacci_directions(37))
    rng = np.random.RandomState(0)
    rec, lig = rng.uniform(-20, 20, (200, 3)), rng.uniform(-5, 5, (40, 3))
    np.testing.assert_array_equal(setup_sim.swarm_centers(rec, lig, 9),
                                  jsetup.swarm_centers(rec, lig, 9))
    cfg = dict(receptor_pdb="r", ligand_pdb="l", glowworms=50, use_anm=True,
               anm_rec=3, anm_lig=4)
    ours = setup_sim.sample_glowworms(trng.ReferenceRng(5), rec[0],
                                      setup_sim.SetupConfig(**cfg))
    ref = jsetup.sample_glowworms(jrng.ReferenceRng(5), rec[0], jsetup.SetupConfig(**cfg))
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (50, 14)


def test_tools_cli_matches(raw, tmp_path):
    """``lightdock-tpu-torch-tools setup`` and ``flatten`` write what
    ``lightdock-tpu-tools`` writes from the same argv."""
    argv = ["setup", str(raw / "rec.pdb"), str(raw / "lig.pdb"), "-s", "4", "-g", "12",
            "--anm", "--anm-rec", "2", "--anm-lig", "5", "--seed", "9",
            "--starting-points-seed", "13", "--noh"]
    assert cli_tools.main(argv + ["--workdir", str(tmp_path / "port")]) == 0
    assert jcli_tools.main(argv + ["--workdir", str(tmp_path / "jax")]) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    modes = np.random.RandomState(3).standard_normal((4, N_REC, 3)).astype(np.float32)
    np.save(tmp_path / "modes.npy", modes)
    for tools, name in ((cli_tools, "port.npy"), (jcli_tools, "jax.npy")):
        assert tools.main(["flatten", str(tmp_path / "modes.npy"), str(tmp_path / name)]) == 0
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    flat = np.load(tmp_path / "port.npy")
    assert flat.dtype == np.float64 and flat.shape == (4 * N_REC * 3,)
    assert cli_tools.build_arg_parser().prog == "lightdock-tpu-torch-tools"
