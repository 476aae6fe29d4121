"""Docking models: a PDB structure as flat typed arrays.

Copy of ``lightdock_tpu/scoring/models.py``: the ``DockingModel`` record
and the per-method model functions (DFIREDockingModel, reference
src/dfire.rs:114-191; DNADockingModel, src/dna.rs:248-365;
PYDOCKDockingModel, src/pydock.rs:253-381).  One build a structure at
setup time; everything downstream reads only these arrays.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np

from ..utils.pdb import Structure
from . import tables

log = logging.getLogger("lightdock_tpu_torch")


class UnsupportedAtomError(ValueError):
    pass


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


def _base_bookkeeping(structure: Structure, active: List[str], passive: List[str]):
    """Membrane beads (``MMB`` residues' ``BJ`` atoms) and the atom indexes
    of each restraint residue, shared by every method."""
    active_set = set(active)
    passive_set = set(passive)
    membrane: List[int] = []
    active_map: Dict[str, List[int]] = {}
    passive_map: Dict[str, List[int]] = {}
    for i in range(structure.num_atoms):
        res_id = structure.res_ids[i]
        if structure.res_names[i] + structure.atom_names[i] == "MMBBJ":
            membrane.append(i)
        if res_id in active_set:
            active_map.setdefault(res_id, []).append(i)
        if res_id in passive_set:
            passive_map.setdefault(res_id, []).append(i)
    return np.asarray(membrane, dtype=np.int64), active_map, passive_map


def _reshape_nmodes(nmodes, num_anm: int, num_atoms: int) -> np.ndarray:
    if num_anm == 0 or nmodes is None or len(nmodes) == 0:
        return np.zeros((0, num_atoms, 3), dtype=np.float64)
    flat = np.asarray(nmodes, dtype=np.float64).reshape(-1)
    expected = num_anm * num_atoms * 3
    if flat.shape[0] != expected:
        raise ValueError(
            f"ANM array has {flat.shape[0]} values, expected {expected} "
            f"({num_anm} modes x {num_atoms} atoms x 3)")
    return flat.reshape(num_anm, num_atoms, 3)


def build_dfire_model(structure: Structure, active=(), passive=(),
                      nmodes=None, num_anm: int = 0) -> DockingModel:
    """DFIRE atom typing (reference src/dfire.rs:114-191)."""
    t = tables.dfire_tables()
    residue_index = t["residue_index"]
    atom_slot = t["atom_slot"]
    atomres = t["atomres"]

    types = np.empty(structure.num_atoms, dtype=np.int32)
    for i in range(structure.num_atoms):
        res_name = structure.res_names[i]
        try:
            rnum = residue_index[res_name]
        except KeyError:
            raise UnsupportedAtomError(
                f"Residue name {res_name!r} not supported in DFIRE scoring function")
        key = res_name + structure.atom_names[i]
        anum = atom_slot.get(key)
        if anum is None:
            raise UnsupportedAtomError(f"Not supported atom type {key!r}")
        types[i] = atomres[rnum][anum]

    membrane, active_map, passive_map = _base_bookkeeping(structure, list(active), list(passive))
    return DockingModel(
        method="dfire",
        coordinates=structure.coordinates.copy(),
        num_anm=num_anm,
        nmodes=_reshape_nmodes(nmodes, num_anm, structure.num_atoms),
        membrane=membrane,
        active_restraints=active_map,
        passive_restraints=passive_map,
        atom_types=types,
    )


def _amber_assign(structure: Structure, method: str):
    """AMBER type and charge assignment shared by DNA and PYDOCK.

    DNA refuses unknown atoms (reference src/dna.rs:318-331); PYDOCK falls
    back to the element wildcard ``*-X`` with a warning (reference
    src/pydock.rs:322-347).  In both, an N-terminal ``H1``/``H2``/``H3``
    missing from the table is looked up as ``RES-H``, and that id (or the
    wildcard) is the one the charge lookups read.
    """
    t = tables.amber_tables(method)
    amber_types = t["amber_types"]
    ele_charges_t = t["ele_charges"]
    nt_ele_charges_t = t["nt_ele_charges"]
    vdw_charges_t = t["vdw_charges"]
    vdw_radii_t = t["vdw_radii"]

    n = structure.num_atoms
    ele = np.empty(n, dtype=np.float64)
    vdw_c = np.empty(n, dtype=np.float64)
    vdw_r = np.empty(n, dtype=np.float64)
    tag = method.upper()

    for i in range(n):
        res_name = structure.res_names[i]
        atom_name = structure.atom_names[i].strip()
        atom_id = f"{res_name}-{atom_name}"

        amber = amber_types.get(atom_id)
        if amber is None:
            if atom_name in ("H1", "H2", "H3"):
                atom_id = f"{res_name}-H"
                amber = amber_types.get(atom_id)
                if amber is None:
                    raise UnsupportedAtomError(f"{tag} Error: Atom [{atom_id!r}] not supported")
            elif method == "pydock":
                log.warning("PYDOCK Warning: Atom [%r] not supported, trying generic", atom_id)
                if not atom_name:
                    raise UnsupportedAtomError(
                        f"PYDOCK Error: Atom element could not be guessed from [{atom_name!r}]")
                atom_id = f"*-{atom_name[0]}"
                amber = amber_types.get(atom_id)
                if amber is None:
                    raise UnsupportedAtomError(f"PYDOCK Error: Atom [{atom_id!r}] not supported")
            else:
                raise UnsupportedAtomError(f"DNA Error: Atom [{atom_id!r}] not supported")

        charge = ele_charges_t.get(atom_id)
        if charge is None:
            charge = nt_ele_charges_t.get(atom_id)
            if charge is None:
                raise UnsupportedAtomError(
                    f"{tag} Error: Atom [{atom_id!r}] electrostatics charge not found")
        ele[i] = charge

        try:
            vdw_c[i] = vdw_charges_t[amber]
            vdw_r[i] = vdw_radii_t[amber]
        except KeyError:
            raise UnsupportedAtomError(
                f"{tag} Error: Atom [{atom_id!r}] VDW parameters not found")
    return ele, vdw_c, vdw_r


def build_amber_model(structure: Structure, method: str, active=(), passive=(),
                      nmodes=None, num_anm: int = 0) -> DockingModel:
    ele, vdw_c, vdw_r = _amber_assign(structure, method)
    if method == "pydock":
        log.info("Atoms read: %d", structure.num_atoms)
    membrane, active_map, passive_map = _base_bookkeeping(structure, list(active), list(passive))
    return DockingModel(
        method=method,
        coordinates=structure.coordinates.copy(),
        num_anm=num_anm,
        nmodes=_reshape_nmodes(nmodes, num_anm, structure.num_atoms),
        membrane=membrane,
        active_restraints=active_map,
        passive_restraints=passive_map,
        ele_charges=ele,
        vdw_charges=vdw_c,
        vdw_radii=vdw_r,
    )


def build_model(structure: Structure, method: str, active=(), passive=(),
                nmodes=None, num_anm: int = 0) -> DockingModel:
    if method == "dfire":
        return build_dfire_model(structure, active, passive, nmodes, num_anm)
    if method in ("dna", "pydock"):
        return build_amber_model(structure, method, active, passive, nmodes, num_anm)
    raise ValueError(f"unknown scoring method: {method!r}")
