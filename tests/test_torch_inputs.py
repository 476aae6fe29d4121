"""The port's host input layer against its JAX originals on the same files:
the PDB reader, setup.json, ``build_model``, the positions files, the
gso_N.out reader and the assembled simulation's scoring parameters.  The
inputs are hand-written PDB records and complexes written by
``standin.write_complex``."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu import simulation as jsim  # noqa: E402
from lightdock_tpu.scoring import models as jmodels  # noqa: E402
from lightdock_tpu.utils import metrics as jmetrics  # noqa: E402
from lightdock_tpu.utils import output as jout  # noqa: E402
from lightdock_tpu.utils import pdb as jpdb  # noqa: E402
from lightdock_tpu.utils import positions as jpos  # noqa: E402
from lightdock_tpu.utils import setupfile as jsetup  # noqa: E402
from lightdock_tpu_torch import simulation as tsim  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine.params import BatchScoringParams, from_reference  # noqa: E402
from lightdock_tpu_torch.scoring import models as tmodels  # noqa: E402
from lightdock_tpu_torch.scoring import tables as ttables  # noqa: E402
from lightdock_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from lightdock_tpu_torch.utils import output as tout  # noqa: E402
from lightdock_tpu_torch.utils import pdb as tpdb  # noqa: E402
from lightdock_tpu_torch.utils import positions as tpos  # noqa: E402
from lightdock_tpu_torch.utils import setupfile as tsetup  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def atom(serial, name, res, chain, resseq, icode=" ", xyz=(0.0, 0.0, 0.0),
         record="ATOM  "):
    """One PDB record in the fixed columns (a four-letter name at 12)."""
    field = name if len(name) == 4 else f" {name:<3}"
    x, y, z = xyz
    return (f"{record}{serial:5d} {field} {res:>3} {chain}{resseq:4d}{icode}   "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00")


def write_pdb(path, records):
    path.write_text("\n".join(["REMARK a hand-written structure", *records,
                               "TER", "END"]) + "\n")
    return path


def parse_both(path):
    return tpdb.parse_pdb(path), jpdb.parse_pdb(path)


def assert_structures_equal(ours, ref):
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    for name in ("atom_names", "res_names", "res_ids", "chain_ids"):
        assert getattr(ours, name) == list(getattr(ref, name)), name
    np.testing.assert_array_equal(ours.coordinates, ref.coordinates)
    assert ours.coordinates.dtype == np.float64 and ours.num_atoms == ref.num_atoms


def assert_models_equal(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_parse_pdb_matches(tmp_path):
    """Insertion codes, four-letter atom names, HETATM records, negative
    coordinates and records that are not atoms: the same Structure."""
    path = write_pdb(tmp_path / "mixed.pdb", [
        atom(1, "N", "ALA", "A", 1, xyz=(11.104, -6.134, 0.5)),
        atom(2, "CA", "ALA", "A", 1, xyz=(-111.639, 6.071, -5.147)),
        atom(3, "HD21", "ASN", "A", 2, icode="A", xyz=(1.0, 2.0, 3.0)),
        atom(4, "H2'1", "DA", "B", 1000, xyz=(9.999, -9.999, 0.001)),
        atom(5, "BJ", "MMB", "C", 3, xyz=(0.0, 0.0, 40.0), record="HETATM"),
        "ANISOU    5  BJ  MMB C   3     100    100    100      0      0      0",
        atom(6, "O", "HOH", " ", 9, record="HETATM"),
    ])
    ours, ref = parse_both(path)
    assert_structures_equal(ours, ref)
    assert ours.res_ids == ["A.ALA.1", "A.ALA.1", "A.ASN.2A", "B.DA.1000", "C.MMB.3", ".HOH.9"]
    assert ours.atom_names[3] == "H2'1"


@pytest.mark.parametrize("method", ["dfire", "dna", "pydock"])
def test_write_complex_parses_and_builds(tmp_path, method):
    """A complex written by ``write_complex``: each PDB file parses to the
    same Structure and builds the same model in both packages, the
    coordinates rounded to 0.001 A, the restraint residue present."""
    setup, positions = standin.write_complex(tmp_path, method, 70, 40, 6, num_anm=2)
    table = tsetup.SetupFile.from_file(setup)
    for name, which in (("rec", "receptor"), ("lig", "ligand")):
        ours, ref = parse_both(tmp_path / f"lightdock_{name}.pdb")
        assert_structures_equal(ours, ref)
        np.testing.assert_array_equal(ours.coordinates, np.round(ours.coordinates, 3))
        active, passive = table.restraints(which)
        nm = np.load(tmp_path / f"{name}_nm.npy")
        assert nm.shape == (2, ours.num_atoms, 3)
        model = tmodels.build_model(ours, method, active, passive, nm, 2)
        assert_models_equal(model, jmodels.build_model(ref, method, active, passive, nm, 2))
        assert len(model.active_restraints) == 1
    assert tpos.parse_positions(positions[0]).shape == (6, 11)


@pytest.mark.parametrize("data", [
    {"receptor_pdb": "r.pdb", "ligand_pdb": "l.pdb", "seed": None},
    {"receptor_pdb": "r.pdb", "ligand_pdb": "l.pdb"},
    {"receptor_pdb": "r.pdb", "ligand_pdb": "l.pdb", "seed": 7, "use_anm": True,
     "anm_rec": 10, "anm_lig": 3, "swarms": 400, "membrane": False,
     "receptor_restraints": {"active": ["A.ALA.1"], "passive": ["A.GLY.2"],
                             "blocked": ["A.SER.9"]},
     "ligand_restraints": {"active": [], "passive": ["B.DA.1"]}},
])
def test_setupfile_matches(data):
    """A null or missing seed is the default seed, missing keys take their
    defaults, unknown keys and a restraint table's 'blocked' are ignored."""
    ours, ref = tsetup.SetupFile.from_dict(data), jsetup.SetupFile.from_dict(data)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for which in ("receptor", "ligand"):
        assert ours.restraints(which) == ref.restraints(which)
    if data.get("seed") is None:
        assert ours.seed == 324324
    with pytest.raises(KeyError):
        tsetup.SetupFile.from_dict({"receptor_pdb": "r.pdb"})


def _structure(records, tmp_path):
    return parse_both(write_pdb(tmp_path / "s.pdb", records))


def test_build_model_fallbacks_match(tmp_path):
    """The N-terminal H1 looked up as RES-H (DNA and PYDOCK), PYDOCK's
    element wildcard ``*-X`` for an unknown atom, the DFIRE membrane beads
    and the restraint maps, active and passive, with a residue absent from
    the structure."""
    amber = [atom(1, "N", "ALA", "A", 1), atom(2, "H1", "ALA", "A", 1, xyz=(1, 0, 0)),
             atom(3, "H3", "ALA", "A", 1, xyz=(0, 1, 0)), atom(4, "CA", "GLY", "A", 2),
             atom(5, "P", "DA", "B", 3)]
    ours, ref = _structure(amber, tmp_path)
    for method in ("dna", "pydock"):
        a = tmodels.build_model(ours, method, ["A.ALA.1", "Z.ALA.9"], ["A.GLY.2"])
        assert_models_equal(a, jmodels.build_model(ref, method, ["A.ALA.1", "Z.ALA.9"],
                                                   ["A.GLY.2"]))
        assert a.active_restraints == {"A.ALA.1": [0, 1, 2]}
        assert a.passive_restraints == {"A.GLY.2": [3]}
    wild = amber + [atom(6, "CZZ", "ALA", "A", 1), atom(7, "SQ", "GLY", "A", 2)]
    ours, ref = _structure(wild, tmp_path)
    a = tmodels.build_model(ours, "pydock")
    assert_models_equal(a, jmodels.build_model(ref, "pydock"))
    pydock = ttables.amber_tables("pydock")
    assert a.ele_charges[5] == pydock["ele_charges"]["*-C"]
    membrane = [atom(1, "CA", "ALA", "A", 1), atom(2, "BJ", "MMB", "M", 2, record="HETATM"),
                atom(3, "N", "GLY", "A", 3), atom(4, "BJ", "MMB", "M", 4, record="HETATM")]
    ours, ref = _structure(membrane, tmp_path)
    a = tmodels.build_model(ours, "dfire", ["A.GLY.3"], [])
    assert_models_equal(a, jmodels.build_model(ref, "dfire", ["A.GLY.3"], []))
    np.testing.assert_array_equal(a.membrane, [1, 3])


@pytest.mark.parametrize("method,records", [
    ("dfire", [atom(1, "CA", "XYZ", "A", 1)]),              # unknown residue
    ("dfire", [atom(1, "QQ", "ALA", "A", 1)]),              # unknown atom type
    ("dna", [atom(1, "CZZ", "ALA", "A", 1)]),               # DNA has no wildcard
    ("dna", [atom(1, "H1", "DA", "B", 1)]),                 # no DA-H to fall back to
    ("pydock", [atom(1, "QQ", "ALA", "A", 1)]),             # no *-Q wildcard
    ("pydock", [atom(1, "H1", "DA", "B", 1)]),
])
def test_build_model_refusals_match(tmp_path, method, records):
    """The same atoms are refused, with the same message, in both."""
    ours, ref = _structure(records, tmp_path)
    with pytest.raises(jmodels.UnsupportedAtomError) as theirs:
        jmodels.build_model(ref, method)
    with pytest.raises(tmodels.UnsupportedAtomError, match="Error|supported") as exc:
        tmodels.build_model(ours, method)
    assert str(exc.value) == str(theirs.value)
    assert issubclass(tmodels.UnsupportedAtomError, ValueError)
    with pytest.raises(ValueError, match="unknown scoring method"):
        tmodels.build_model(ours, "vdw")


def test_nmodes_size_refused(tmp_path):
    ours, ref = _structure([atom(1, "CA", "ALA", "A", 1), atom(2, "N", "ALA", "A", 1)], tmp_path)
    for module, s in ((tmodels, ours), (jmodels, ref)):
        with pytest.raises(ValueError, match="expected 12"):
            module.build_model(s, "dfire", nmodes=np.zeros(11), num_anm=2)


@pytest.mark.parametrize("text,error", [
    ("1 2 3 1 0 0 0\n\n4 5 6 0 1 0 0\n", None),
    ("  -1.5e-3 2 3 1 0 0 0 0.25 -0.5  \n", None),
    ("", "empty"),
    ("\n  \n", "empty"),
    ("1 2 3 1 0 0 0\n1 2 3 1 0 0\n", "ragged"),
])
def test_parse_positions_matches(tmp_path, text, error):
    path = tmp_path / "initial_positions_3.dat"
    path.write_text(text)
    if error:
        for module in (tpos, jpos):
            with pytest.raises(ValueError, match=error):
                module.parse_positions(path)
        return
    ours = tpos.parse_positions(path)
    np.testing.assert_array_equal(ours, jpos.parse_positions(path))
    assert ours.dtype == np.float64


@pytest.mark.parametrize("name,swarm", [
    ("initial_positions_0.dat", 0), ("initial_positions_17.dat", 17),
    ("initial_positions_-3.dat", -3), ("initial_positions_x.dat", None),
    ("positions_1.dat", None), ("initial_positions_1.dat.bak", None),
])
def test_parse_swarm_id_matches(tmp_path, name, swarm):
    path = tmp_path / "some" / name
    if swarm is None:
        for module in (tpos, jpos):
            with pytest.raises(ValueError, match="swarm id"):
                module.parse_swarm_id(path)
    else:
        assert tpos.parse_swarm_id(path) == jpos.parse_swarm_id(path) == swarm


def test_read_gso_output_matches(tmp_path):
    """A snapshot written by ``write_gso_output`` (with ANM columns) reads
    back the same arrays in both packages, to the text's decimals; a line
    the format does not hold is refused."""
    rng = np.random.RandomState(3)
    poses = rng.uniform(-30, 30, (9, 11))
    luc, vis, sco = rng.uniform(0, 9, 9), rng.uniform(0, 5, 9), rng.uniform(-50, 50, 9)
    nn = rng.randint(0, 6, 9)
    path = tmp_path / "gso_10.out"
    tout.write_gso_output(path, poses, luc, nn, vis, sco)
    ours, ref = tout.read_gso_output(path), jout.read_gso_output(path)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ours[0], poses, atol=5e-8)
    np.testing.assert_array_equal(ours[2], nn)
    path.write_text(path.read_text() + "not a glowworm\n")
    with pytest.raises(ValueError, match="unparseable"):
        tout.read_gso_output(path)


@pytest.mark.parametrize("method,num_anm,dtype", [
    ("dfire", 0, np.float64), ("dfire", 2, np.float64), ("dna", 2, np.float64),
    ("pydock", 0, np.float64), ("dna", 0, np.float32),
])
def test_load_simulation_matches(tmp_path, method, num_anm, dtype):
    """``load_simulation`` on the same files (ANM read from the working
    directory): the same models, positions, swarm id and seed, and
    ``batch_params`` equal field by field to ``from_reference`` of JAX's."""
    setup, positions = standin.write_complex(tmp_path, method, 50, 35, 5, num_anm=num_anm)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        ours = tsim.load_simulation(setup, positions[0], method)
        ref = jsim.load_simulation(setup, positions[0], method)
    finally:
        os.chdir(cwd)
    assert (ours.swarm_id, ours.seed, ours.use_anm) == (ref.swarm_id, ref.seed, ref.use_anm) == (
        0, 324324, num_anm > 0)
    np.testing.assert_array_equal(ours.positions, ref.positions)
    assert_models_equal(ours.receptor, ref.receptor)
    assert_models_equal(ours.ligand, ref.ligand)
    a, b = ours.batch_params(dtype), from_reference(ref.batch_params(dtype))
    for f in dataclasses.fields(BatchScoringParams):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_load_anm_size_checks(tmp_path):
    """ANM files of the wrong size are refused in both, from the working
    directory or from ``anm_dir``."""
    setup, positions = standin.write_complex(tmp_path, "dfire", 20, 10, 3, num_anm=2)
    np.save(tmp_path / "lig_nm.npy", np.zeros((2, 9, 3)))
    for module in (tsim, jsim):
        with pytest.raises(ValueError, match="ligand"):
            module.load_simulation(setup, positions[0], "dfire", anm_dir=str(tmp_path))
    np.save(tmp_path / "rec_nm.npy", np.zeros(5))
    for module in (tsim, jsim):
        table = module.SetupFile.from_file(setup)
        with pytest.raises(ValueError, match="receptor"):
            module.load_anm(table, 20, 10, anm_dir=str(tmp_path))


def test_run_metrics_matches(tmp_path):
    """The same events and keys as the JAX original, in JSON lines."""
    records = []
    for module, name in ((tmetrics, "ours"), (jmetrics, "ref")):
        m = module.RunMetrics(str(tmp_path / f"{name}.jsonl"), context={"backend": "cpu"})
        m.segment(0, 10, 2000, 0.5)
        m.segment(10, 15, 1000, 0.0)
        s = m.summary()
        m.close()
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        records.append((s, [sorted(json.loads(ln)) for ln in lines]))
    assert records[0] == records[1]
    assert records[0][0] == {"total_poses_scored": 3000, "total_seconds": 0.5,
                             "poses_per_s": 6000.0}
    assert tmetrics.log.name == "lightdock_tpu_torch.metrics"
    none = tmetrics.RunMetrics()
    assert none.summary()["poses_per_s"] is None
