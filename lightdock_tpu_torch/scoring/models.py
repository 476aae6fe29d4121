"""The docking-model record: one structure as flat typed arrays.

Copy of the ``DockingModel`` dataclass of
``lightdock_tpu/scoring/models.py``.  The PDB model builders are not
copied: they come with the port of the command line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class DockingModel:
    """Typed flat-array model of one structure for one scoring method."""

    method: str                      # 'dfire' | 'dna' | 'pydock'
    coordinates: np.ndarray          # (N, 3) f64
    num_anm: int
    nmodes: np.ndarray               # (num_anm, N, 3) f64
    membrane: np.ndarray             # (M,) i64 atom indexes of MMB.BJ beads
    active_restraints: Dict[str, List[int]]   # res_id -> atom indexes
    passive_restraints: Dict[str, List[int]]
    # DFIRE:
    atom_types: Optional[np.ndarray] = None   # (N,) i32 in [0, 168]
    # DNA / PYDOCK:
    ele_charges: Optional[np.ndarray] = None  # (N,) f64
    vdw_charges: Optional[np.ndarray] = None  # (N,) f64
    vdw_radii: Optional[np.ndarray] = None    # (N,) f64

    @property
    def num_atoms(self) -> int:
        return self.coordinates.shape[0]

    def restraint_segments(self):
        """Vectorisable encoding of the active restraints.

        Returns (res_of_atom (N,) i32 with -1 for unrestrained atoms,
        num_residues).  A residue counts as satisfied when any of its atoms
        is in the interface (reference src/scoring.rs:21-36); the
        denominator is the number of restraint residues present.
        """
        res_of_atom = np.full(self.num_atoms, -1, dtype=np.int32)
        for slot, (_res, atom_idx) in enumerate(sorted(self.active_restraints.items())):
            res_of_atom[np.asarray(atom_idx, dtype=np.int64)] = slot
        return res_of_atom, len(self.active_restraints)
