"""The port's copies of the host layer equal their originals on the same
inputs: constants, tables, potentials, the docking-model record, the
parameter builder and ``from_reference``, the random stream, the snapshot
text and sidecars, the split of pose rows, the BSAS clustering, and the
stand-in systems."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__  # noqa: E402
from lightdock_tpu import analysis as janalysis  # noqa: E402
from lightdock_tpu import setup_sim as jsetup  # noqa: E402
from lightdock_tpu import constants as jc  # noqa: E402
from lightdock_tpu.engine import energy_batch as eb  # noqa: E402
from lightdock_tpu.ops import quaternion as jqt  # noqa: E402
from lightdock_tpu.scoring import models as jmodels  # noqa: E402
from lightdock_tpu.scoring import potentials as jpot  # noqa: E402
from lightdock_tpu.scoring import tables as jtables  # noqa: E402
from lightdock_tpu.utils import output as jout  # noqa: E402
from lightdock_tpu.utils import pdb as jpdb  # noqa: E402
from lightdock_tpu.utils import positions as jpos  # noqa: E402
from lightdock_tpu.utils import rng as jrng  # noqa: E402
from lightdock_tpu_torch import analysis as tanalysis  # noqa: E402
from lightdock_tpu_torch import constants as tc  # noqa: E402
from lightdock_tpu_torch import setup_sim as tsetup  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine import params as tparams  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import kernel_params  # noqa: E402
from lightdock_tpu_torch.ops import quaternion as tqt  # noqa: E402
from lightdock_tpu_torch.scoring import models as tmodels  # noqa: E402
from lightdock_tpu_torch.scoring import potentials as tpot  # noqa: E402
from lightdock_tpu_torch.scoring import tables as ttables  # noqa: E402
from lightdock_tpu_torch.utils import clusters as tclusters  # noqa: E402
from lightdock_tpu_torch.utils import output as tout  # noqa: E402
from lightdock_tpu_torch.utils import pdb as tpdb  # noqa: E402
from lightdock_tpu_torch.utils import positions as tpos  # noqa: E402
from lightdock_tpu_torch.utils import rng as trng  # noqa: E402

FIELDS = [f.name for f in dataclasses.fields(eb.BatchScoringParams)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_params_equal(ours, ref, skip=()):
    assert [f.name for f in dataclasses.fields(tparams.BatchScoringParams)] == FIELDS
    for name in FIELDS:
        if name in skip:
            continue
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None or isinstance(b, (str, bool, int)):
            assert a == b, name
        else:
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_constants_match():
    names = [n for n in dir(jc) if n.isupper()]
    assert names and names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n


def test_tables_and_potentials_match(tmp_path):
    ours, ref = ttables.dfire_tables(), jtables.dfire_tables()
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]))
    for method in ("dna", "pydock"):
        assert ttables.amber_tables(method) == jtables.amber_tables(method)
    pot = tpot.synthetic_potential()
    np.testing.assert_array_equal(pot, jpot.synthetic_potential())
    for bins in (32, 20):
        np.testing.assert_array_equal(tpot.potential_by_bins(pot, bins),
                                      jpot.potential_by_bins(pot, bins))
    path = tmp_path / "DCparams"
    np.savetxt(path, pot[:tpot.TABLE_SIZE] * 0.25)
    np.testing.assert_array_equal(tpot.load_potential(path),
                                  jpot.load_potential(path))
    with pytest.raises(FileNotFoundError):
        tpot.load_potential(tmp_path / "absent", allow_synthetic=False)


def _models(module, method, num_anm, seed):
    rng = np.random.RandomState(seed)

    def model(n):
        kw = {}
        if method == "dfire":
            kw["atom_types"] = rng.randint(0, 168, size=n).astype(np.int32)
        else:
            kw.update(ele_charges=rng.uniform(-1, 1, n),
                      vdw_charges=rng.uniform(0, 0.5, n),
                      vdw_radii=rng.uniform(0.5, 2.5, n))
        return module.DockingModel(
            method=method, coordinates=rng.uniform(-15, 15, (n, 3)),
            num_anm=num_anm, nmodes=rng.standard_normal((num_anm, n, 3)),
            membrane=np.array([3, 4, 9], dtype=np.int64),
            active_restraints={"B.7": [5, 6], "A.1": [0, 2]},
            passive_restraints={"A.3": [1]}, **kw)

    return model(40), model(23)


@pytest.mark.parametrize("method,mode,num_anm,dtype", [
    ("dfire", "gather", 0, np.float64),
    ("dfire", "types", 2, np.float32),
    ("dfire", "steps", 2, np.float32),
    ("dfire", "steps", 0, np.float64),
    ("dfire", "auto", 0, np.float64),
    ("dna", "auto", 2, np.float32),
    ("pydock", "auto", 0, np.float64),
])
def test_build_batch_params_matches(method, mode, num_anm, dtype):
    """Field by field, with a membrane and restraints on both sides."""
    rec, lig = _models(tmodels, method, num_anm, seed=4)
    jrec, jlig = _models(jmodels, method, num_anm, seed=4)
    for a, b in ((rec, jrec), (lig, jlig)):
        for x, y in zip(a.restraint_segments(), b.restraint_segments()):
            np.testing.assert_array_equal(x, y)
    pot = tpot.synthetic_potential()
    kw = dict(use_anm=num_anm > 0, dtype=dtype,
              potential=pot if method == "dfire" else None)
    ours = tparams.build_batch_params(rec, lig, dfire_mode=mode, **kw)
    ref = eb.build_batch_params(jrec, jlig, dfire_mode=mode, **kw)
    # 'auto' at f32 builds the type-indexed tables here and the step
    # tables there; every other mode builds the same fields.
    if mode == "auto" and ref.dfire_dq is not None:
        assert ours.dfire_dq is None
        _assert_params_equal(ours, ref, skip=("dfire_dq", "dfire_thresholds",
                                              "dfire_rec_half", "dfire_lig_onehot"))
    else:
        _assert_params_equal(ours, ref)
    assert (ours.dfire_dq is not None) == (method == "dfire" and mode == "steps")
    if method == "dfire":
        _assert_params_equal(tparams.ensure_dfire_types(ours),
                             eb.ensure_dfire_types(ref), skip=("dfire_dq",))
        np.testing.assert_array_equal(
            tparams.dfire_bin_thresholds(ours.dist_to_bins),
            eb.dfire_bin_thresholds(ref.dist_to_bins))
        for fn in ("dfire_type_tables", "dfire_step_tables"):
            for x, y in zip(getattr(tparams, fn)(ours.atom_types_rec,
                                                 ours.atom_types_lig, pot,
                                                 ours.dist_to_bins, dtype=dtype),
                            getattr(eb, fn)(ref.atom_types_rec,
                                            ref.atom_types_lig, pot,
                                            ref.dist_to_bins, dtype=dtype)):
                assert x.dtype == y.dtype, fn
                np.testing.assert_array_equal(x, y, err_msg=fn)
    with pytest.raises(ValueError, match="dfire_mode"):
        tparams.build_batch_params(*_models(tmodels, "dfire", 0, 1),
                                   use_anm=False, dfire_mode="dense",
                                   potential=pot)


def test_from_reference():
    """A JAX-built params (with the step form's dq) becomes the port's
    dataclass with every field equal; the port's own params survive it."""
    rec, lig = _models(jmodels, "dfire", 2, seed=6)
    ref = eb.build_batch_params(rec, lig, use_anm=True, dtype=np.float32,
                                potential=jpot.synthetic_potential(),
                                dfire_mode="steps")
    ours = tparams.from_reference(ref)
    assert type(ours) is tparams.BatchScoringParams
    _assert_params_equal(ours, ref)
    assert ours.dfire_dq is not None and ours.dfire_dq.shape[1:] == (40, 23)
    again = tparams.from_reference(ours)
    _assert_params_equal(again, ref)


@pytest.mark.parametrize("seed,n", [(324324, 1), (324324, 4000), (7, 37)])
def test_uniform_f64_stream_matches(seed, n):
    np.testing.assert_array_equal(trng.uniform_f64_stream(seed, n),
                                  jrng.uniform_f64_stream(seed, n))


def test_gso_output_matches(tmp_path):
    rng = np.random.RandomState(5)
    g = 13
    poses = rng.standard_normal((g, 11)) * 10
    luc = rng.uniform(0, 20, g)
    nn = rng.randint(0, 6, g)
    vis = rng.uniform(0, 5, g)
    sco = rng.standard_normal(g) * 100
    text = tout.format_gso_output(poses, luc, nn, vis, sco)
    assert text == jout.format_gso_output(poses, luc, nn, vis, sco)
    tout.write_gso_output(tmp_path / "a.out", poses, luc, nn, vis, sco)
    jout.write_gso_output(tmp_path / "b.out", poses, luc, nn, vis, sco)
    assert (tmp_path / "a.out").read_text() == (tmp_path / "b.out").read_text()
    # Sidecars written by either package read back the same in the other.
    tout.write_state_sidecar(tmp_path / "a.out", 10, t=poses[:, :3], vision=vis)
    jout.write_state_sidecar(tmp_path / "b.out", 10, t=poses[:, :3], vision=vis)
    for path in (tmp_path / "a.out", tmp_path / "b.out"):
        ours, ref = tout.read_state_sidecar(path), jout.read_state_sidecar(path)
        assert ours[0] == ref[0] == 10 and ours[1].keys() == ref[1].keys()
        for k in ref[1]:
            np.testing.assert_array_equal(ours[1][k], ref[1][k])
    assert tout.read_state_sidecar(tmp_path / "none.out") is None


@pytest.mark.parametrize("cutoff", [None, 1.5])
def test_clusters_match(cutoff):
    """``utils.clusters`` equals ``lightdock_tpu.analysis``: the RMSD matrix
    bit for bit and the same BSAS clusters, on poses in a few tight groups
    (so clusters gather several members) with tied scores."""
    rng = np.random.RandomState(3)
    centres = rng.uniform(-6, 6, size=(5, 1, 3))
    coords = (centres[rng.randint(0, 5, 40)]
              + rng.standard_normal((40, 17, 3)) * 0.8)
    scores = np.round(rng.standard_normal(40), 1)
    np.testing.assert_array_equal(tclusters.pose_rmsd_matrix(coords),
                                  janalysis.pose_rmsd_matrix(coords))
    kw = {} if cutoff is None else {"cutoff": cutoff}
    ours = tclusters.cluster_bsas(coords, scores, **kw)
    ref = janalysis.cluster_bsas(coords, scores, **kw)
    assert tclusters.DEFAULT_RMSD_CUTOFF == janalysis.DEFAULT_RMSD_CUTOFF
    assert [dataclasses.astuple(c) for c in ours] == [dataclasses.astuple(c) for c in ref]
    assert any(len(c.members) > 1 for c in ours) and len(ours) > 1


@pytest.mark.parametrize("t", [tc.DEFAULT_ROTATION_STEP, 0.5])
def test_slerp_host_matches(t):
    """``ops.quaternion.slerp_host`` equals the original NumPy ``slerp``
    bit for bit, one quaternion a call as the host engine calls it and in
    a batch: near-parallel pairs (the linear branch), antiparallel ones
    (the flip) and the rest (the spherical branch)."""
    rng = np.random.RandomState(9)
    q1 = rng.standard_normal((600, 4)) * 1.7
    q2 = q1 + rng.standard_normal((600, 4)) * np.repeat([1e-4, 1e-2, 1.0], 200)[:, None]
    q2[::7] = -q2[::7]
    for a, b in zip(q1, q2):
        np.testing.assert_array_equal(tqt.slerp_host(a, b, t), jqt.slerp(a, b, t))
    np.testing.assert_array_equal(tqt.slerp_host(q1, q2, t), jqt.slerp(q1, q2, t))


def test_reference_rng_matches():
    """Draws of every size, across the 4,096-double refills, equal the
    JAX package's stream and ``uniform_f64_stream``."""
    ours, ref = trng.ReferenceRng(324324), jrng.ReferenceRng(324324)
    drawn = []
    for n in [1, 3, 2, 4090, 7, 1, 5000, 3]:
        a, b = ours.gen(n), ref.gen(n)
        np.testing.assert_array_equal(a, b)
        drawn.append(a)
    np.testing.assert_array_equal(np.concatenate(drawn),
                                  trng.uniform_f64_stream(324324, sum(map(len, drawn))))


def test_analysis_host_pieces_match(tmp_path):
    """The host parts copied from ``lightdock_tpu.analysis`` and
    ``setup_sim``: ``rewrite_pdb_coords`` (with a serial offset),
    ``write_cluster_repr``, ``collect_swarm_results`` (numeric swarm order,
    cluster representatives), ``prepare_structure``, and the plain PDB
    reader against the JAX package's."""
    setup, _ = standin.write_complex(tmp_path, "dfire", 30, 12, 2, seed=2)
    lig_pdb = tmp_path / "lightdock_lig.pdb"
    coords = np.random.RandomState(4).uniform(-999, 999, (12, 3))
    for module, name in ((tanalysis, "a.pdb"), (janalysis, "b.pdb")):
        with open(tmp_path / name, "w") as fh:
            assert module.rewrite_pdb_coords(lig_pdb, coords, fh, serial_offset=99990) == 12
    assert (tmp_path / "a.pdb").read_text() == (tmp_path / "b.pdb").read_text()
    clusters = [tclusters.Cluster(3, -1.234565, [3, 1]), tclusters.Cluster(0, 7.0, [0])]
    tanalysis.write_cluster_repr(clusters, tmp_path / "a.repr")
    janalysis.write_cluster_repr([janalysis.Cluster(*dataclasses.astuple(c))
                                  for c in clusters], tmp_path / "b.repr")
    assert (tmp_path / "a.repr").read_text() == (tmp_path / "b.repr").read_text()
    rng = np.random.RandomState(6)
    for s in (10, 2, 0):
        out = tmp_path / "root" / f"swarm_{s}"
        out.mkdir(parents=True)
        jout.write_gso_output(out / "gso_5.out", rng.standard_normal((4, 7)),
                              rng.uniform(0, 9, 4), rng.randint(0, 5, 4),
                              rng.uniform(0, 5, 4), rng.standard_normal(4))
    (tmp_path / "root" / "swarm_10" / "cluster.repr").write_text("0:2:1.0:3:x\n1:1:0.5:1:y\n")
    ours = tanalysis.collect_swarm_results(tmp_path / "root", 5)
    ref = janalysis.collect_swarm_results(tmp_path / "root", 5)
    assert [(r.swarm, r.glowworm) for r in ours] == [(r.swarm, r.glowworm) for r in ref]
    assert [r.swarm for r in ours] == [0] * 4 + [2] * 4 + [10] * 2
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.pose, b.pose)
        assert (a.luciferin, a.num_neighbors, a.vision, a.scoring) == \
            (b.luciferin, b.num_neighbors, b.vision, b.scoring)
    for module, name in ((tsetup, "p.pdb"), (jsetup, "q.pdb")):
        assert module.prepare_structure(lig_pdb, tmp_path / name, True, True, True) == 12
    assert (tmp_path / "p.pdb").read_text() == (tmp_path / "q.pdb").read_text()
    ours, ref = tpdb.parse_pdb_plain(lig_pdb), jpdb.parse_pdb(lig_pdb)
    assert (ours.atom_names, ours.res_ids) == (ref.atom_names, ref.res_ids)
    np.testing.assert_array_equal(ours.coordinates, ref.coordinates)


@pytest.mark.parametrize("use_anm,anm_rec,anm_lig", [(False, 0, 0), (True, 2, 3),
                                                     (True, 0, 2)])
def test_split_positions_matches(use_anm, anm_rec, anm_lig):
    rows = np.random.RandomState(1).standard_normal((9, 7 + anm_rec + anm_lig))
    for a, b in zip(tpos.split_positions(rows, use_anm, anm_rec, anm_lig),
                    jpos.split_positions(rows, use_anm, anm_rec, anm_lig)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,num_anm,seed", [("dfire", 0, 0), ("dfire", 2, 4),
                                                 ("dna", 3, 1)])
def test_toy_system_matches_graft_entry(method, num_anm, seed):
    """The stand-in reproduces ``__graft_entry__._toy_system`` from the
    same seed: the same positions and, as the kernel path takes them, the
    same params (the JAX one also builds the step form's dq, which the
    port never builds)."""
    ours, pos, k = standin.toy_system(60, 30, 9, num_anm=num_anm, seed=seed,
                                      method=method)
    ref, rpos, rk = __graft_entry__._toy_system(60, 30, 9, num_anm=num_anm,
                                                seed=seed, method=method)
    assert k == rk
    np.testing.assert_array_equal(pos, rpos)
    _assert_params_equal(ours, ref, skip=("dfire_dq", "dfire_thresholds",
                                          "dfire_rec_half", "dfire_lig_onehot"))
    _assert_params_equal(kernel_params(ours),
                         kernel_params(tparams.from_reference(ref)))
    if method == "dfire":
        steps, spos, _ = standin.toy_system(60, 30, 9, num_anm=num_anm, seed=seed,
                                            method=method, dfire_mode="steps")
        np.testing.assert_array_equal(spos, rpos)
        _assert_params_equal(steps, ref)   # the JAX stand-in builds the step form


def test_membrane_system():
    """The 1k4c-shaped stand-in at a small size: a membrane slab on the
    receptor, one restraint on each side, no ANM, and one swarm within 5 A
    of the point 40 A above the receptor's centre."""
    params, pos = standin.membrane_system(50, n_rec=400, n_lig=300, seed=2)
    rec = params.rec_coords
    assert params.method == "dfire" and not params.use_anm
    assert params.dfire_rec_half is not None and params.dfire_dq is None
    slab = rec[:, 2] > standin.MEMBRANE_SLAB_Z
    np.testing.assert_array_equal(params.rec_membrane_mask, slab.astype(np.float32))
    assert params.rec_num_membrane == slab.sum() > 0
    assert params.rec_res_onehot.shape == (1, 400)
    assert params.lig_res_onehot.shape == (1, 300)
    centre = rec.astype(np.float64).mean(axis=0) + [0, 0, standin.SWARM_DISTANCE]
    assert pos.shape == (50, 7)
    assert (np.linalg.norm(pos[:, :3] - centre, axis=1) <= standin.SWARM_RADIUS).all()
    np.testing.assert_allclose(np.linalg.norm(pos[:, 3:], axis=1), 1.0)
