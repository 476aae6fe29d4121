"""The port's analysis (``lightdock_tpu_torch.analysis``, ``cli_analysis``)
against the JAX package's on the CPU: the per-pose functions at rtol
1e-12 (the clash count exactly, with chunks forced small too), the files
``cluster.repr``, ``rank_by_scoring.list`` (with and without metrics and
a reference ligand), ``lightdock_N.pdb`` and ``top/*.pdb`` byte for byte,
and the whole flow: ``lightdock-tpu-torch-tools setup`` ->
``lightdock-tpu-torch`` -> ``lightdock-tpu-torch-analysis all`` against
``lightdock-tpu-analysis all`` on the same swarm directories."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu import analysis as janalysis  # noqa: E402
from lightdock_tpu import cli_analysis as jcli_analysis  # noqa: E402
from lightdock_tpu.utils.output import write_gso_output as jwrite_gso  # noqa: E402
from lightdock_tpu_torch import analysis, cli, cli_analysis, cli_tools, standin  # noqa: E402
from lightdock_tpu_torch.utils.clusters import cluster_bsas  # noqa: E402
from lightdock_tpu_torch.utils.pdb import parse_pdb  # noqa: E402

CPU = "cpu"
N_REC, N_LIG = 70, 25


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU (the DFIRE
    flow ran 240 times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _poses(rng, g, n_anm=0, groups=4):
    """Poses in a few tight groups (so clusters gather members) with
    normalised quaternions and ANM columns."""
    centres = rng.uniform(-6, 6, (groups, 3))
    t = centres[rng.randint(0, groups, g)] + rng.standard_normal((g, 3)) * 0.3
    q = rng.standard_normal((groups, 4))[rng.randint(0, groups, g)] \
        + rng.standard_normal((g, 4)) * 0.02
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([t, q, rng.uniform(-1, 1, (g, 2 * n_anm))], axis=1)


@pytest.mark.parametrize("n_anm", [0, 3])
def test_pose_functions_match(n_anm):
    rng = np.random.RandomState(n_anm)
    lig = rng.uniform(-8, 8, (N_LIG, 3))
    modes = rng.standard_normal((n_anm, N_LIG, 3)) * 0.3
    poses = _poses(rng, 40, n_anm)
    ours = analysis.transform_ligand_batch(lig, modes, poses, n_anm > 0, n_anm, n_anm, CPU)
    ref = janalysis.transform_ligand_batch(lig, modes, poses, n_anm > 0, n_anm, n_anm)
    assert ours.dtype == torch.float64 and ours.device.type == "cpu"
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12, atol=0)
    # sq + sq^T - 2 flat flat^T cancels to rounding noise on the diagonal,
    # where the sqrt lifts it to ~1e-7: there the two summation orders are
    # held on the squared RMSD, to 1e-12 of the scale that cancels.
    rmsd, ref_rmsd = analysis.pose_rmsd_matrix(ref, CPU).numpy(), janalysis.pose_rmsd_matrix(ref)
    apart = ref_rmsd > 1e-3
    np.testing.assert_allclose(rmsd[apart], ref_rmsd[apart], rtol=1e-12, atol=0)
    scale = (ref.reshape(40, -1) ** 2).sum(axis=1).max() / N_LIG
    np.testing.assert_allclose(rmsd ** 2, ref_rmsd ** 2, rtol=0, atol=1e-12 * scale)
    target = ref[0] + rng.standard_normal(ref[0].shape)
    np.testing.assert_allclose(analysis.ligand_rmsd(ref, target, CPU).numpy(),
                               janalysis.ligand_rmsd(ref, target), rtol=1e-12, atol=0)
    scores = np.round(rng.standard_normal(40), 1)
    ours_c = analysis.cluster_bsas(ref, scores, 1.5, CPU)
    assert [(c.representative, c.scoring, c.members) for c in ours_c] == \
        [(c.representative, c.scoring, c.members)
         for c in janalysis.cluster_bsas(ref, scores, 1.5)]
    assert any(len(c.members) > 1 for c in ours_c)
    assert ours_c == cluster_bsas(ref, scores, 1.5)


@pytest.mark.parametrize("chunks", [None, (3, 7), analysis.clash_chunks(11, 137, 29, 17 * 150)])
def test_count_clashes_matches(chunks):
    """Exact counts against the JAX package's and a brute-force count, at
    the default chunks (one here), at chunks forced to 3 poses x 7 receptor
    atoms, and at ``clash_chunks``' under a budget of 150 pairs a chunk."""
    rng = np.random.RandomState(3)
    rec = rng.uniform(-6, 6, (137, 3))
    lig = rng.uniform(-6, 6, (11, 29, 3))
    got = analysis.count_clashes(rec, lig, 1.9, CPU, chunks=chunks)
    assert got.dtype == torch.int64
    d = lig[:, None, :, :] - rec[None, :, None, :]
    brute = (((d * d).sum(-1)) < 1.9 ** 2).sum(axis=(1, 2))
    np.testing.assert_array_equal(got.numpy(), janalysis.count_clashes(rec, lig, 1.9))
    np.testing.assert_array_equal(got.numpy(), brute)
    assert brute.min() > 0
    assert analysis.clash_chunks(11, 137, 29) == (11, 137)
    assert analysis.clash_chunks(11, 137, 29, 17 * 150) == (5, 1)


def _swarms(root, n_anm, rng, step=10):
    """Three swarms of 12 glowworms each with tied scores, written by the
    JAX package's writer."""
    for s in range(3):
        poses = _poses(rng, 12, n_anm)
        scores = np.round(rng.standard_normal(12) * 3, 1)
        out = root / f"swarm_{s}"
        out.mkdir(parents=True)
        jwrite_gso(out / f"gso_{step}.out", poses, rng.uniform(0, 9, 12),
                   rng.randint(0, 6, 12), rng.uniform(0, 5, 12), scores)


@pytest.mark.parametrize("n_anm", [0, 2])
def test_analysis_files_match(tmp_path, n_anm):
    """cluster.repr, lightdock_N.pdb, rank_by_scoring.list (plain, with
    metrics, with a reference ligand) and top/*.pdb: byte-identical."""
    standin.write_complex(tmp_path / "in", "dfire", N_REC, N_LIG, 2, num_anm=n_anm, seed=5)
    rec_pdb = tmp_path / "in" / "lightdock_rec.pdb"
    lig_pdb = tmp_path / "in" / "lightdock_lig.pdb"
    modes = (np.load(tmp_path / "in" / "lig_nm.npy") if n_anm
             else np.zeros((0, N_LIG, 3)))
    for name in ("port", "jax"):
        _swarms(tmp_path / name, n_anm, np.random.RandomState(8))
    port, jax_root = tmp_path / "port", tmp_path / "jax"
    args = (modes, n_anm > 0, n_anm, n_anm)
    for s in range(3):
        ours = analysis.cluster_swarm_dir(port / f"swarm_{s}", lig_pdb, 10, *args,
                                          cutoff=2.0, device=CPU)
        janalysis.cluster_swarm_dir(jax_root / f"swarm_{s}", lig_pdb, 10, *args, cutoff=2.0)
        assert len(ours) < 12
    analysis.generate_conformations(lig_pdb, port / "swarm_0/gso_10.out", port / "conf",
                                    *args, num=5, device=CPU)
    janalysis.generate_conformations(lig_pdb, jax_root / "swarm_0/gso_10.out",
                                     jax_root / "conf", *args, num=5)
    for tag, kw in (("plain", {}), ("metrics", {}), ("reference", {"reference_pdb": lig_pdb})):
        metrics = (None if tag == "plain" else
                   (analysis.make_pose_metrics(rec_pdb, lig_pdb, *args, clash_cutoff=5.0,
                                               device=CPU, **kw),
                    janalysis.make_pose_metrics(rec_pdb, lig_pdb, *args, clash_cutoff=5.0,
                                                **kw)))
        out = f"rank_{tag}.list"
        ranked = analysis.rank_swarms(port, 10, out, pose_metrics=metrics and metrics[0])
        j_ranked = janalysis.rank_swarms(jax_root, 10, out, pose_metrics=metrics and metrics[1])
        if tag != "plain":
            assert max(r.clashes for r in ranked) > 0
    assert min(r.rmsd for r in ranked) >= 0
    analysis.write_top(rec_pdb, lig_pdb, ranked, port / "top", *args, top_n=4, device=CPU)
    janalysis.write_top(rec_pdb, lig_pdb, j_ranked, jax_root / "top", *args, top_n=4)
    a = {p.relative_to(port): p.read_bytes() for p in port.rglob("*") if p.is_file()}
    b = {p.relative_to(jax_root): p.read_bytes() for p in jax_root.rglob("*") if p.is_file()}
    assert sorted(a) == sorted(b) and len(a) == 3 * 2 + 5 + 3 + 4
    assert a == b
    top = parse_pdb(port / "top" / "top_1.pdb")
    assert top.num_atoms == N_REC + N_LIG


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.mark.parametrize("method,n_anm", [("dfire", 0), ("dna", 2)])
def test_whole_flow(tmp_path, method, n_anm):
    """Raw PDB files -> tools setup (3 swarms x 20) -> the command line on
    the CPU (10 steps) -> analysis all --platform cpu, against
    lightdock-tpu-analysis all on a copy of the same swarm directories;
    then rank with metrics, a reference ligand and a wider clash cutoff."""
    src = tmp_path / "src"
    standin.write_complex(src, method, N_REC, N_LIG, 2, num_anm=n_anm, seed=6)
    for side in ("rec", "lig"):
        shutil.copy(src / f"lightdock_{side}.pdb", tmp_path / f"{side}.pdb")
    run = tmp_path / "run"
    argv = ["setup", str(tmp_path / "rec.pdb"), str(tmp_path / "lig.pdb"), "-s", "3",
            "-g", "20", "--workdir", str(run)]
    if n_anm:
        argv += ["--anm", "--anm-rec", str(n_anm), "--anm-lig", str(n_anm)]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli_tools.main(argv) == 0
    for f in src.glob("*_nm.npy"):
        shutil.copy(f, run / f.name)
    with _cwd(run), contextlib.redirect_stdout(io.StringIO()):
        assert cli.main([str(run / "setup.json"), str(run / "init/initial_positions_*.dat"),
                         "10", method, "--platform", "cpu", "--energy-mode", "kernel"]) == 0
    roots = {name: tmp_path / name for name in ("port", "jax")}
    for root in roots.values():
        for s in range(3):
            shutil.copytree(run / f"swarm_{s}", root / f"swarm_{s}")
    common = ["--setup", str(run / "setup.json"), "--anm-dir", str(run)]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli_analysis.main(["all", str(roots["port"]), "10", *common,
                                  "--platform", "cpu"]) == 0
        assert jcli_analysis.main(["all", str(roots["jax"]), "10", *common]) == 0
        ref_pdb = str(run / "lightdock_lig.pdb")
        for main, root, extra in ((cli_analysis.main, roots["port"], ["--platform", "cpu"]),
                                  (jcli_analysis.main, roots["jax"], [])):
            assert main(["rank", str(root), "10", *common, "--reference-pdb", ref_pdb,
                         "--clash-cutoff", "12", *extra]) == 0
    files = {name: {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
                    if p.is_file() and p.suffix != ".npz"} for name, root in roots.items()}
    names = {p.as_posix() for p in files["port"]}
    assert {"rank_by_scoring.list", "top/top_1.pdb", "top/top_10.pdb",
            "swarm_2/cluster.repr"} <= names
    assert files["port"] == files["jax"]
    rank = (roots["port"] / "rank_by_scoring.list").read_text().splitlines()
    assert len(rank) > 1 and " -1.000 " not in rank[1]


def test_analysis_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without a card, ``auto`` and ``cuda`` raise before reading anything;
    the functions' default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["--platform", "auto"], ["--platform", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_analysis.main(["rank", str(tmp_path), "10", *platform])
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.pose_rmsd_matrix(np.zeros((2, 3, 3)))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli_analysis.main(["rank", str(tmp_path), "10", "--platform", "cpu"]) == 0
    assert cli_analysis.build_arg_parser().prog == "lightdock-tpu-torch-analysis"
