"""Minimal PDB structure reader.

Port of ``lightdock_tpu/utils/pdb.py``: ``parse_pdb`` reads through the
port's native reader (``utils.native.parse_pdb``, ``csrc/io_native.cpp``),
as the JAX package's reads through its own; ``parse_pdb_plain`` is the
same reader in Python, its plain version for the tests.  Atom order is
file order (ATOM/HETATM records), which matches the reference's chains ->
residues -> atoms flattening (reference src/dfire.rs:132-186) for the
sorted single-model files the LightDock setup tooling writes.

Columns are fixed: atom name [12:16], residue [17:20], chain [21],
residue serial [22:26], insertion code [26], x/y/z [30:38], [38:46],
[46:54].  Restraint residue ids are ``"{chain}.{resname}.{serial}{icode}"``
(reference src/dfire.rs:139-142).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List

import numpy as np

from . import native


@dataclasses.dataclass
class Structure:
    """Columnar atom table for one parsed structure."""

    atom_names: List[str]
    res_names: List[str]
    res_ids: List[str]       # "{chain}.{resname}.{serial}{icode?}" per atom
    chain_ids: List[str]
    coordinates: np.ndarray  # (N, 3) float64

    @property
    def num_atoms(self) -> int:
        return len(self.atom_names)


def parse_pdb(path) -> Structure:
    """Parse ATOM/HETATM records of a PDB file into a Structure (the
    native reader)."""
    return Structure(*native.parse_pdb(path))


def parse_pdb_plain(path) -> Structure:
    """``parse_pdb`` in Python: the native reader's plain version."""
    atom_names: List[str] = []
    res_names: List[str] = []
    res_ids: List[str] = []
    chain_ids: List[str] = []
    coords: List[tuple] = []

    for line in pathlib.Path(path).read_text().splitlines():
        rec = line[:6]
        if rec != "ATOM  " and rec != "HETATM":
            continue
        res_name = line[17:20].strip()
        chain_id = line[21].strip()
        atom_names.append(line[12:16].strip())
        res_names.append(res_name)
        res_ids.append(f"{chain_id}.{res_name}.{line[22:26].strip()}{line[26].strip()}")
        chain_ids.append(chain_id)
        coords.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))

    return Structure(
        atom_names=atom_names,
        res_names=res_names,
        res_ids=res_ids,
        chain_ids=chain_ids,
        coordinates=np.asarray(coords, dtype=np.float64).reshape(-1, 3),
    )
