"""BSAS clustering of a swarm's poses by ligand RMSD.

Copy of ``lightdock_tpu/analysis.py`` ``DEFAULT_RMSD_CUTOFF``,
``pose_rmsd_matrix``, ``Cluster`` and ``cluster_bsas`` (NumPy), held equal
to the originals by ``tests/test_torch_host.py``; the precision tool
clusters with them.  ``cluster_bsas_from_rmsd`` is the BSAS loop alone,
on a given RMSD matrix: the port's analysis (``analysis.py``, the rest of
that module) computes the matrix on the card and clusters with it here.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

DEFAULT_RMSD_CUTOFF = 4.0  # lightdock3 BSAS default (Angstrom)


def pose_rmsd_matrix(coords: np.ndarray) -> np.ndarray:
    """(G, G) pairwise ligand RMSD between transformed pose coordinates."""
    g, n, _ = coords.shape
    flat = coords.reshape(g, -1)
    sq = (flat * flat).sum(axis=1)
    cross = flat @ flat.T
    msd = (sq[:, None] + sq[None, :] - 2.0 * cross) / n
    return np.sqrt(np.maximum(msd, 0.0))


@dataclasses.dataclass
class Cluster:
    representative: int
    scoring: float
    members: List[int]


def cluster_bsas(coords: np.ndarray, scoring: np.ndarray,
                 cutoff: float = DEFAULT_RMSD_CUTOFF) -> List[Cluster]:
    """BSAS clustering: visit poses best-scoring first; join the first
    cluster whose representative is within ``cutoff`` RMSD, else found a
    new cluster."""
    return cluster_bsas_from_rmsd(pose_rmsd_matrix(coords), scoring, cutoff)


def cluster_bsas_from_rmsd(rmsd: np.ndarray, scoring: np.ndarray,
                           cutoff: float = DEFAULT_RMSD_CUTOFF) -> List[Cluster]:
    """``cluster_bsas`` on the (G, G) pairwise RMSD matrix ``rmsd``."""
    order = np.argsort(-scoring, kind="stable")
    clusters: List[Cluster] = []
    for g in order:
        for c in clusters:
            if rmsd[g, c.representative] <= cutoff:
                c.members.append(int(g))
                break
        else:
            clusters.append(Cluster(int(g), float(scoring[g]), [int(g)]))
    return clusters
