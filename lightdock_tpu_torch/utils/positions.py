"""initial_positions_N.dat parsing, swarm ids and the split of pose rows.

Copy of ``parse_positions``, ``parse_swarm_id`` and ``split_positions``
from ``lightdock_tpu/utils/positions.py``.

Row layout (reference src/swarm.rs:34-51): columns 0-2 translation, 3-6
quaternion (w, x, y, z), then ``anm_rec`` receptor ANM coefficients and the
remaining columns ligand ANM coefficients.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np


def parse_positions(path) -> np.ndarray:
    """Parse a positions file into a (G, D) float64 array: whitespace-
    separated floats, one glowworm a line (reference
    src/bin/lightdock-rust.rs:60-75).  Empty and ragged files are
    refused."""
    rows = []
    for line in pathlib.Path(path).read_text().splitlines():
        if not line.strip():
            continue
        rows.append([float(tok) for tok in line.split()])
    if not rows:
        raise ValueError(f"empty positions file: {path}")
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise ValueError(f"ragged positions file: {path}")
    return np.asarray(rows, dtype=np.float64)


def parse_swarm_id(path) -> int:
    """N of .../initial_positions_N.dat, negative N too (reference
    bin:150-156)."""
    name = pathlib.Path(path).name
    m = re.fullmatch(r"initial_positions_(-?\d+)\.dat", name)
    if not m:
        raise ValueError(f"could not parse swarm id from {name!r}")
    return int(m.group(1))


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
