"""Permissive setup.json parsing.

Copy of ``lightdock_tpu/utils/setupfile.py``.  The reference deserialises a
fixed struct but ignores unknown keys and never uses several parsed ones
(reference src/bin/lightdock-rust.rs:27-48), so any JSON object is
accepted and only the fields the engine needs are read.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional

from ..constants import DEFAULT_SEED


@dataclasses.dataclass
class SetupFile:
    receptor_pdb: str
    ligand_pdb: str
    seed: int = DEFAULT_SEED
    anm_rec: int = 0
    anm_lig: int = 0
    use_anm: bool = False
    receptor_restraints: Optional[Dict[str, List[str]]] = None
    ligand_restraints: Optional[Dict[str, List[str]]] = None
    raw: Optional[dict] = None  # the whole JSON object as read

    @staticmethod
    def from_file(path) -> "SetupFile":
        return SetupFile.from_dict(json.loads(pathlib.Path(path).read_text()))

    @staticmethod
    def from_dict(data: dict) -> "SetupFile":
        seed = data.get("seed")
        if seed is None:
            seed = DEFAULT_SEED
        return SetupFile(
            receptor_pdb=data["receptor_pdb"],
            ligand_pdb=data["ligand_pdb"],
            seed=int(seed),
            anm_rec=int(data.get("anm_rec", 0)),
            anm_lig=int(data.get("anm_lig", 0)),
            use_anm=bool(data.get("use_anm", False)),
            receptor_restraints=data.get("receptor_restraints"),
            ligand_restraints=data.get("ligand_restraints"),
            raw=data,
        )

    def restraints(self, which: str) -> tuple:
        """(active, passive) restraint residue-id lists for 'receptor' or
        'ligand': empty lists without a table; a table must carry 'active'
        and 'passive' (other keys, such as 'blocked', are ignored;
        reference src/bin/lightdock-rust.rs:257-272)."""
        table = self.receptor_restraints if which == "receptor" else self.ligand_restraints
        if table is None:
            return [], []
        return list(table["active"]), list(table["passive"])
