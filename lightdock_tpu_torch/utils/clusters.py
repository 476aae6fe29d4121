"""BSAS clustering of a swarm's poses by ligand RMSD.

Copy of ``lightdock_tpu/analysis.py`` ``DEFAULT_RMSD_CUTOFF``,
``pose_rmsd_matrix``, ``Cluster`` and ``cluster_bsas`` (NumPy), held equal
to the originals by ``tests/test_torch_host.py``.  The rest of that module
(conformations, ranking, top-N) is not ported: it imports no JAX and
serves the port's ``gso_N.out`` as it is.
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
    order = np.argsort(-scoring, kind="stable")
    rmsd = pose_rmsd_matrix(coords)
    clusters: List[Cluster] = []
    for g in order:
        for c in clusters:
            if rmsd[g, c.representative] <= cutoff:
                c.members.append(int(g))
                break
        else:
            clusters.append(Cluster(int(g), float(scoring[g]), [int(g)]))
    return clusters
