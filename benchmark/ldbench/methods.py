"""The scoring methods the benchmark takes, one table: for each, the
residues the generator writes on the receptor and on the ligand, the atom
names its tables type, and the maker of the plain reference's scorer.  A
configuration whose ``method`` is not here is refused by :func:`method`,
at set-up, before any input is made.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable, NamedTuple

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "reference"
AMINO_ACIDS = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
               "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
NUCLEOTIDES = ("DA", "DC", "DG", "DT")


def dfire_atoms() -> list:
    """(residue, atom name) of DFIRE's ``atom_slot`` keys."""
    tables = json.loads((REFERENCE / "dfire_tables.json").read_text())
    return [(k[:3], k[3:]) for k in tables["atom_slot"]]


def amber_atoms() -> list:
    """(residue, atom name) of the AMBER ``amber_types`` keys."""
    tables = json.loads((REFERENCE / "dna_tables.json").read_text())
    return [tuple(k.split("-", 1)) for k in tables["amber_types"]]


def dfire_scorer(cx, rec, lig, device, dtype):
    from reference.dfire import DfireScorer, read_potential

    return DfireScorer(rec, lig, read_potential(cx.data / "DCparams"), device, dtype=dtype)


def dna_scorer(cx, rec, lig, device, dtype):
    from reference.dna import DnaScorer

    return DnaScorer(rec, lig, device, dtype=dtype)


class Method(NamedTuple):
    receptor: tuple       # residues the receptor's atoms cycle through
    ligand: tuple         # and the ligand's
    atoms: Callable       # () -> [(residue, atom name)] the tables type
    scorer: Callable      # (complex, receptor Side, ligand Side, device, dtype)


METHODS = {
    "dfire": Method(AMINO_ACIDS, AMINO_ACIDS, dfire_atoms, dfire_scorer),
    "dna": Method(AMINO_ACIDS, NUCLEOTIDES, amber_atoms, dna_scorer),
}


def method(name: str) -> Method:
    """The entry of ``name``; raises where the benchmark has no reference
    for it."""
    if name not in METHODS:
        raise ValueError(f"no reference scorer for method {name!r}")
    return METHODS[name]
