"""Reading LightDock's ``gso_N.out`` snapshots and writing them, plainly.

A header line, then a line a glowworm: ``(x, y, z, qw, qx, qy, qz[, anm...])``
at 7 decimals, ``0 0`` (receptor and ligand ids), luciferin at 8 decimals,
the number of neighbours, the vision range at 3 decimals and the score at 8
decimals.
"""

from __future__ import annotations

import pathlib

import numpy as np

HEADER = "#Coordinates  RecID  LigID  Luciferin  Neighbor's number  Vision Range  Scoring"


def read(path):
    """(poses (G, D), luciferin, neighbours, vision, score) of a snapshot;
    raises ValueError on a line it cannot read."""
    poses, cols = [], []
    for line in pathlib.Path(path).read_text().splitlines()[1:]:
        if not line.strip():
            continue
        head, sep, tail = line.partition(")")
        fields = tail.split()
        if not sep or not head.startswith("(") or len(fields) != 6:
            raise ValueError(f"{path}: unreadable line {line!r}")
        poses.append([float(v) for v in head[1:].split(",")])
        cols.append([float(fields[2]), float(fields[3]), float(fields[4]), float(fields[5])])
    if not poses:
        raise ValueError(f"{path}: no glowworms")
    cols = np.asarray(cols, dtype=np.float64)
    return (np.asarray(poses, dtype=np.float64), cols[:, 0], cols[:, 1].astype(np.int64),
            cols[:, 2], cols[:, 3])


def write(path, poses, luciferin, neighbours, vision, score) -> None:
    """The snapshot of a state, as LightDock writes it."""
    lines = [HEADER]
    for g in range(poses.shape[0]):
        pose = ", ".join(f"{v:.7f}" for v in poses[g])
        lines.append(f"({pose})    0    0   {luciferin[g]:.8f}  {int(neighbours[g])} "
                     f"{vision[g]:.3f} {score[g]:.8f}")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
