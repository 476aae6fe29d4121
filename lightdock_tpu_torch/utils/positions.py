"""Split of initial-position rows (copy of ``split_positions`` from
``lightdock_tpu/utils/positions.py``).

Row layout (reference src/swarm.rs:34-51): columns 0-2 translation, 3-6
quaternion (w, x, y, z), then ``anm_rec`` receptor ANM coefficients and the
remaining columns ligand ANM coefficients.
"""

from __future__ import annotations

import numpy as np


def split_positions(positions: np.ndarray, use_anm: bool, anm_rec: int, anm_lig: int):
    """Split raw rows into (translations, quaternions, anm_rec, anm_lig).

    ANM columns are only consumed when ``use_anm`` is set (reference
    src/swarm.rs:40-51); otherwise zero-width arrays are returned.
    """
    g = positions.shape[0]
    t = positions[:, 0:3].copy()
    q = positions[:, 3:7].copy()
    if use_anm and anm_rec > 0:
        a_rec = positions[:, 7:7 + anm_rec].copy()
    else:
        a_rec = np.zeros((g, 0), dtype=np.float64)
    if use_anm and anm_lig > 0:
        a_lig = positions[:, 7 + anm_rec:].copy()
        if a_lig.shape[1] != anm_lig:
            raise ValueError(
                f"positions rows have {a_lig.shape[1]} ligand ANM columns, expected {anm_lig}")
    else:
        a_lig = np.zeros((g, 0), dtype=np.float64)
    return t, q, a_rec, a_lig
