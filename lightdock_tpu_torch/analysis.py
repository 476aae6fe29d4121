"""Post-simulation analysis: conformations, clustering, ranking, top-N.

Port of ``lightdock_tpu/analysis.py``, behind
``lightdock-tpu-torch-analysis``.  The reference leaves this stage to
lightdock3's tools (reference example/1czy/analysis.sh:10-35:
lgd_generate_conformations.py, lgd_cluster_bsas.py, lgd_rank.py,
lgd_top.py); the files written here equal the JAX package's byte for
byte:

* ``generate_conformations``: one PDB per pose of a snapshot, the ligand
  moved by the pose (rotation, translation, ANM);
* ``cluster_swarm_dir``: BSAS clustering of a swarm's poses by ligand
  RMSD, written as ``cluster.repr`` lines
  ``cluster_id:size:scoring:glowworm_id:lightdock_N.pdb``;
* ``rank_swarms``: every swarm's snapshot at a step merged and sorted by
  scoring into ``rank_by_scoring.list``, with the RMSD against a reference
  ligand and the clash count where ``make_pose_metrics`` gives them;
* ``write_top``: receptor + moved ligand PDBs of the best N poses.

The per-pose work runs in torch at float64 on ``device``, the card unless
the caller asks for the CPU (``engine.runner.cuda_device``: without a card
it raises): the pose transform (``transform_ligand_batch``), the pairwise
RMSD matrix (``pose_rmsd_matrix``, its (G, 3N) product in
``torch.matmul``), the RMSD against a reference (``ligand_rmsd``) and the
clash count (``count_clashes``, chunked under ``CLASH_BUDGET_BYTES``).
The BSAS loop, the files and the text stay on the host
(``utils.clusters.cluster_bsas_from_rmsd``).

Where the arithmetic allows, it is the JAX package's NumPy order: the
rotation's three products are summed as NumPy's einsum sums them and the
ANM modes in order, so the moved coordinates are the same bits; a squared
distance is the difference, then the sum of its three squares in order.
The RMSD's sums (a matrix product, a mean over atoms) are taken in
another order than NumPy's, within a few ulps.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from .engine.runner import cuda_device
from .ops.quaternion import rotation_matrix
from .utils.clusters import DEFAULT_RMSD_CUTOFF, Cluster, cluster_bsas_from_rmsd
from .utils.output import read_gso_output
from .utils.pdb import parse_pdb
from .utils.positions import split_positions

CLASH_BUDGET_BYTES = 2_000_000_000   # count_clashes' temporaries, at most
_CLASH_PAIR_BYTES = 17               # two float64 (pose, rec, lig) arrays and a bool


def _device(device) -> torch.device:
    return cuda_device(device, "lightdock_tpu_torch.analysis")


def _f64(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _no_modes(lig) -> np.ndarray:
    return np.zeros((0, lig.num_atoms, 3))


# -- pose application -------------------------------------------------------


def transform_ligand_batch(lig_coords, nmodes, poses: np.ndarray, use_anm: bool,
                           anm_rec: int, anm_lig: int, device="cuda") -> torch.Tensor:
    """(G, Nl, 3) float64 ligand coordinates of every pose on ``device``:
    rotate, translate, then the ligand's ANM term (the reference's pose
    semantics, src/dfire.rs:282-302).  ``nmodes`` is the ligand's
    (anm_lig, Nl, 3) mode tensor."""
    device = _device(device)
    t, q, _a_rec, a_lig = split_positions(np.asarray(poses, dtype=np.float64),
                                          use_anm, anm_rec, anm_lig)
    rot = rotation_matrix(_f64(q, device))                 # (G, 3, 3)
    x = _f64(lig_coords, device)
    # out[g, n, a] = sum_b rot[g, a, b] x[n, b], the three products added
    # as NumPy's einsum("gab,nb->gna") adds them: (b0 + b2) + b1.
    prod = [rot[:, None, :, b] * x[None, :, None, b] for b in range(3)]
    out = (prod[0] + prod[2]) + prod[1] + _f64(t, device)[:, None, :]
    if use_anm and a_lig.shape[1] > 0:
        a = _f64(a_lig, device)
        modes = _f64(nmodes, device)
        anm = a[:, 0, None, None] * modes[0]
        for k in range(1, a.shape[1]):
            anm = anm + a[:, k, None, None] * modes[k]
        out = out + anm
    return out


def rewrite_pdb_coords(src_path, coords: np.ndarray, out_handle,
                       serial_offset: int = 0) -> int:
    """Copy the ATOM/HETATM records of ``src_path`` with ``coords`` in
    place of theirs, serials renumbered from ``serial_offset`` + 1; other
    records are skipped.  Returns the atom records written."""
    i = 0
    for line in pathlib.Path(src_path).read_text().splitlines():
        rec = line[:6]
        if rec != "ATOM  " and rec != "HETATM":
            continue
        if len(line) < 54:
            line = line.ljust(54)
        x, y, z = coords[i]
        serial = serial_offset + i + 1
        out_handle.write(
            f"{line[:6]}{min(serial, 99999):5d}{line[11:30]}"
            f"{x:8.3f}{y:8.3f}{z:8.3f}{line[54:]}\n")
        i += 1
    return i


def generate_conformations(ligand_pdb, gso_out, output_dir,
                           nmodes: Optional[np.ndarray],
                           use_anm: bool, anm_rec: int, anm_lig: int,
                           num: Optional[int] = None, device="cuda") -> List[pathlib.Path]:
    """Write lightdock_N.pdb for each pose of a gso_N.out snapshot."""
    lig = parse_pdb(ligand_pdb)
    poses = read_gso_output(gso_out)[0]
    if num is not None:
        poses = poses[:num]
    modes = nmodes if nmodes is not None else _no_modes(lig)
    coords = transform_ligand_batch(lig.coordinates, modes, poses, use_anm,
                                    anm_rec, anm_lig, device).cpu().numpy()
    outdir = pathlib.Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    for g in range(coords.shape[0]):
        path = outdir / f"lightdock_{g}.pdb"
        with open(path, "w") as fh:
            rewrite_pdb_coords(ligand_pdb, coords[g], fh)
            fh.write("END\n")
        written.append(path)
    return written


# -- clustering -------------------------------------------------------------


def pose_rmsd_matrix(coords, device="cuda") -> torch.Tensor:
    """(G, G) pairwise ligand RMSD between transformed pose coordinates
    (G, N, 3), as ``sq + sq^T - 2 flat flat^T`` with the (G, 3N) product
    in ``torch.matmul`` at float64."""
    coords = _f64(coords, _device(device))
    g, n, _ = coords.shape
    flat = coords.reshape(g, -1)
    sq = (flat * flat).sum(dim=1)
    msd = (sq[:, None] + sq[None, :] - 2.0 * torch.matmul(flat, flat.T)) / n
    return torch.sqrt(torch.clamp(msd, min=0.0))


def cluster_bsas(coords, scoring: np.ndarray, cutoff: float = DEFAULT_RMSD_CUTOFF,
                 device="cuda") -> List[Cluster]:
    """BSAS clustering (``utils.clusters.cluster_bsas_from_rmsd``) on the
    RMSD matrix computed on ``device``."""
    rmsd = pose_rmsd_matrix(coords, device).cpu().numpy()
    return cluster_bsas_from_rmsd(rmsd, np.asarray(scoring), cutoff)


def write_cluster_repr(clusters: Sequence[Cluster], path) -> None:
    with open(path, "w") as fh:
        for i, c in enumerate(clusters):
            fh.write(f"{i}:{len(c.members)}:{c.scoring:.5f}:"
                     f"{c.representative}:lightdock_{c.representative}.pdb\n")


def cluster_swarm_dir(swarm_dir, ligand_pdb, step: int,
                      nmodes: Optional[np.ndarray], use_anm: bool,
                      anm_rec: int, anm_lig: int,
                      cutoff: float = DEFAULT_RMSD_CUTOFF, device="cuda") -> List[Cluster]:
    """Cluster one swarm's gso_{step}.out; writes swarm_dir/cluster.repr."""
    swarm_dir = pathlib.Path(swarm_dir)
    lig = parse_pdb(ligand_pdb)
    poses, _l, _n, _v, sco = read_gso_output(swarm_dir / f"gso_{step}.out")
    modes = nmodes if nmodes is not None else _no_modes(lig)
    coords = transform_ligand_batch(lig.coordinates, modes, poses, use_anm,
                                    anm_rec, anm_lig, device)
    clusters = cluster_bsas(coords, sco, cutoff, device)
    write_cluster_repr(clusters, swarm_dir / "cluster.repr")
    return clusters


# -- per-pose quality metrics (RMSD vs a reference, clash count) -------------


def ligand_rmsd(coords, ref_coords, device="cuda") -> torch.Tensor:
    """(G,) ligand RMSD of each transformed pose against reference
    coordinates, without superposition (the receptor frame is shared): the
    RMSD column lgd_rank fills when given a reference structure (reference
    example/1czy/analysis.sh:27-32 runs it without one, leaving -1.000)."""
    device = _device(device)
    d = _f64(coords, device) - _f64(ref_coords, device)[None]
    d2 = d * d
    return torch.sqrt(((d2[..., 0] + d2[..., 1]) + d2[..., 2]).mean(dim=-1))


def clash_chunks(g: int, n_rec: int, n_lig: int,
                 budget_bytes: int = CLASH_BUDGET_BYTES) -> tuple:
    """(poses, receptor atoms) of one ``count_clashes`` chunk, its
    temporaries (``_CLASH_PAIR_BYTES`` a pair) within ``budget_bytes``:
    as many poses as fit with one receptor atom, then as many atoms."""
    pairs = max(1, budget_bytes // _CLASH_PAIR_BYTES)
    poses = min(g, max(1, pairs // max(1, n_lig)))
    return poses, min(n_rec, max(1, pairs // (poses * max(1, n_lig))))


def count_clashes(rec_coords, lig_coords, cutoff: float = 1.9, device="cuda",
                  chunks: Optional[tuple] = None) -> torch.Tensor:
    """(G,) int64 steric clash counts: receptor-ligand atom pairs closer
    than ``cutoff`` (default 1.9 A, a covalent-overlap heavy-atom
    threshold).  d² is the difference, then its squares summed x, y, z in
    that order (as the JAX package's NumPy sums them; no ``torch.cdist``,
    whose matrix-product form rounds otherwise at the cutoff).  Chunked
    over poses and receptor atoms, ``chunks`` = (poses, atoms) or
    ``clash_chunks``' (temporaries within ``CLASH_BUDGET_BYTES``)."""
    device = _device(device)
    rec = _f64(rec_coords, device)
    lig = _f64(lig_coords, device)
    g, n_lig, _ = lig.shape
    n_rec = rec.shape[0]
    pose_chunk, atom_chunk = chunks or clash_chunks(g, n_rec, n_lig)
    c2 = cutoff * cutoff
    out = torch.zeros(g, dtype=torch.int64, device=device)
    for p0 in range(0, g, pose_chunk):
        ligc = lig[p0:p0 + pose_chunk]
        for r0 in range(0, n_rec, atom_chunk):
            recc = rec[r0:r0 + atom_chunk]
            d2 = ligc[:, None, :, 0] - recc[None, :, None, 0]    # (gc, rc, Nl)
            d2.mul_(d2)
            for axis in (1, 2):
                d = ligc[:, None, :, axis] - recc[None, :, None, axis]
                d2.add_(d.mul_(d))
            out[p0:p0 + pose_chunk] += (d2 < c2).sum(dim=(1, 2))
    return out


def make_pose_metrics(receptor_pdb, ligand_pdb, nmodes: Optional[np.ndarray],
                      use_anm: bool, anm_rec: int, anm_lig: int,
                      reference_pdb=None, clash_cutoff: float = 1.9, device="cuda"):
    """A ``poses -> (rmsd, clashes)`` callable for ``rank_swarms``, both
    computed on ``device`` and returned as NumPy arrays.

    ``reference_pdb`` is a ligand structure in the receptor frame with the
    same parsed atoms as ``ligand_pdb`` (e.g. the crystallographic ligand);
    without it the RMSD column stays -1.000 like the reference pipeline's
    default run."""
    device = _device(device)
    lig = parse_pdb(ligand_pdb)
    rec = parse_pdb(receptor_pdb)
    modes = nmodes if nmodes is not None else _no_modes(lig)
    ref_coords = None
    if reference_pdb is not None:
        ref = parse_pdb(reference_pdb)
        if ref.num_atoms != lig.num_atoms:
            raise ValueError(
                f"reference ligand has {ref.num_atoms} atoms, docked ligand "
                f"has {lig.num_atoms}: atom sets must match for RMSD")
        ref_coords = ref.coordinates

    def metrics(poses: np.ndarray):
        coords = transform_ligand_batch(lig.coordinates, modes, poses, use_anm,
                                        anm_rec, anm_lig, device)
        rmsd = (ligand_rmsd(coords, ref_coords, device).cpu().numpy()
                if ref_coords is not None else np.full(coords.shape[0], -1.0))
        clashes = count_clashes(rec.coordinates, coords, clash_cutoff, device)
        return rmsd, clashes.cpu().numpy()

    return metrics


# -- ranking ----------------------------------------------------------------


@dataclasses.dataclass
class RankedPose:
    swarm: int
    glowworm: int
    pose: np.ndarray
    luciferin: float
    num_neighbors: int
    vision: float
    scoring: float
    rmsd: float = -1.0
    clashes: int = 0


def collect_swarm_results(root, step: int,
                          only_cluster_representatives: bool = True
                          ) -> List[RankedPose]:
    """Read every swarm_*/gso_{step}.out under ``root``, swarms in numeric
    order.  Where cluster.repr files exist (and filtering is asked for)
    only the cluster representatives are kept, as lgd_rank keeps them."""
    results: List[RankedPose] = []
    root = pathlib.Path(root)
    for swarm_dir in sorted(root.glob("swarm_*"),
                            key=lambda p: int(p.name.split("_")[1])):
        m = re.fullmatch(r"swarm_(\d+)", swarm_dir.name)
        if not m:
            continue
        swarm_id = int(m.group(1))
        out_file = swarm_dir / f"gso_{step}.out"
        if not out_file.exists():
            continue
        poses, luc, nn, vis, sco = read_gso_output(out_file)
        keep = range(poses.shape[0])
        repr_file = swarm_dir / "cluster.repr"
        if only_cluster_representatives and repr_file.exists():
            keep = [int(line.split(":")[3])
                    for line in repr_file.read_text().splitlines() if line]
        for g in keep:
            results.append(RankedPose(swarm_id, int(g), poses[g], float(luc[g]),
                                      int(nn[g]), float(vis[g]), float(sco[g])))
    return results


def rank_swarms(root, step: int, out_name: str = "rank_by_scoring.list",
                only_cluster_representatives: bool = True,
                pose_metrics=None) -> List[RankedPose]:
    """Merge and sort every swarm's results by scoring; write the rank file
    (layout of reference example/1czy/rank_by_scoring.list).

    ``pose_metrics`` (``make_pose_metrics``) fills the RMSD and Clashes
    columns; without it they stay -1.000 / 0, like the reference pipeline
    run without a reference structure."""
    results = collect_swarm_results(root, step, only_cluster_representatives)
    if pose_metrics is not None and results:
        rmsd, clashes = pose_metrics(np.stack([r.pose for r in results]))
        for r, rm, cl in zip(results, rmsd, clashes):
            r.rmsd, r.clashes = float(rm), int(cl)
    results.sort(key=lambda r: -r.scoring)
    path = pathlib.Path(root) / out_name
    with open(path, "w") as fh:
        fh.write("Swarm  Glowworm   Coordinates"
                 + " " * 45
                 + "RecID  LigID  Luciferin  Neigh   VR     RMSD    PDB"
                 + " " * 13 + "Clashes  Scoring\n")
        for r in results:
            pose_s = ", ".join(f"{v:.3f}" for v in r.pose)
            fh.write(f"{r.swarm:5d} {r.glowworm:6d} ({pose_s})      0      0"
                     f"    {r.luciferin:.5f}     {r.num_neighbors}   "
                     f"{r.vision:.3f}   {r.rmsd:.3f} "
                     f"lightdock_{r.glowworm}.pdb      {r.clashes}   "
                     f"{r.scoring:.3f}\n")
    return results


def write_top(receptor_pdb, ligand_pdb, ranked: Sequence[RankedPose],
              output_dir, nmodes: Optional[np.ndarray], use_anm: bool,
              anm_rec: int, anm_lig: int, top_n: int = 10,
              device="cuda") -> List[pathlib.Path]:
    """Write receptor + moved ligand PDBs of the best ``top_n`` poses
    (top_1.pdb first), the poses moved together on ``device``."""
    lig = parse_pdb(ligand_pdb)
    rec = parse_pdb(receptor_pdb)
    outdir = pathlib.Path(output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    best = list(ranked[:top_n])
    if not best:
        return []
    modes = nmodes if nmodes is not None else _no_modes(lig)
    coords = transform_ligand_batch(lig.coordinates, modes, np.stack([r.pose for r in best]),
                                    use_anm, anm_rec, anm_lig, device).cpu().numpy()
    written = []
    for i in range(len(best)):
        path = outdir / f"top_{i + 1}.pdb"
        with open(path, "w") as fh:
            n = rewrite_pdb_coords(receptor_pdb, rec.coordinates, fh)
            rewrite_pdb_coords(ligand_pdb, coords[i], fh, serial_offset=n)
            fh.write("END\n")
        written.append(path)
    return written
