"""Simulation assembly: files -> models -> scoring parameters.

Copy of ``lightdock_tpu/simulation.py``; ``Simulation.host_scorer`` takes
the device of the port's float64 scoring oracle.  It follows the reference
binary's load path (reference src/bin/lightdock-rust.rs:158-332):
setup.json beside the PDB files, the ``lightdock_`` prefix before the
structure names, the ANM ``.npy`` files read from the working directory
with their size checks, restraints split into active and passive lists.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional

import numpy as np

from . import constants as C
from .engine.energy_host import HostScorer
from .engine.params import BatchScoringParams, build_batch_params
from .scoring.models import DockingModel, build_model
from .utils.pdb import parse_pdb
from .utils.positions import parse_positions, parse_swarm_id
from .utils.setupfile import SetupFile


@dataclasses.dataclass
class Simulation:
    setup: SetupFile
    method: str
    receptor: DockingModel
    ligand: DockingModel
    positions: np.ndarray          # (G, D) raw rows
    swarm_id: Optional[int] = None

    @property
    def seed(self) -> int:
        return self.setup.seed

    @property
    def use_anm(self) -> bool:
        return self.setup.use_anm

    def host_scorer(self, device="cuda") -> HostScorer:
        """The single-pose float64 oracle (``engine.energy_host``) on
        ``device``."""
        return HostScorer(self.method, self.receptor, self.ligand, self.use_anm,
                          device=device)

    def batch_params(self, dtype=np.float64) -> BatchScoringParams:
        """The scoring parameters (``engine.params.build_batch_params``);
        each energy mode adds the DFIRE tables it reads
        (``engine.runner.make_energy``)."""
        return build_batch_params(self.receptor, self.ligand, self.use_anm, dtype=dtype)


def load_structure_pair(setup: SetupFile, simulation_path: str):
    prefix = C.DEFAULT_LIGHTDOCK_PREFIX
    base = pathlib.Path(simulation_path) if simulation_path else pathlib.Path(".")
    return (parse_pdb(base / f"{prefix}{setup.receptor_pdb}"),
            parse_pdb(base / f"{prefix}{setup.ligand_pdb}"))


def load_anm(setup: SetupFile, rec_atoms: int, lig_atoms: int, anm_dir: Optional[str] = None):
    """Read rec_nm.npy and lig_nm.npy (from the working directory, as the
    reference does, unless ``anm_dir`` is given) with the reference's size
    checks (src/bin/lightdock-rust.rs:217-254)."""
    rec_nm = np.zeros(0)
    lig_nm = np.zeros(0)
    base = pathlib.Path(anm_dir) if anm_dir else pathlib.Path(os.getcwd())
    if setup.use_anm:
        if setup.anm_rec > 0:
            rec_nm = np.load(base / C.DEFAULT_REC_NM_FILE).reshape(-1)
            if rec_nm.shape[0] != rec_atoms * 3 * setup.anm_rec:
                raise ValueError(
                    "Number of read ANM in receptor does not correspond to the number of atoms")
        if setup.anm_lig > 0:
            lig_nm = np.load(base / C.DEFAULT_LIG_NM_FILE).reshape(-1)
            if lig_nm.shape[0] != lig_atoms * 3 * setup.anm_lig:
                raise ValueError(
                    "Number of read ANM in ligand does not correspond to the number of atoms")
    return rec_nm, lig_nm


def load_simulation(setup_path, positions_path, method: str,
                    anm_dir: Optional[str] = None) -> Simulation:
    setup_path = pathlib.Path(setup_path)
    setup = SetupFile.from_file(setup_path)

    rec_struct, lig_struct = load_structure_pair(setup, str(setup_path.parent))
    rec_nm, lig_nm = load_anm(setup, rec_struct.num_atoms, lig_struct.num_atoms,
                              anm_dir=anm_dir)

    rec_active, rec_passive = setup.restraints("receptor")
    lig_active, lig_passive = setup.restraints("ligand")

    receptor = build_model(rec_struct, method, rec_active, rec_passive,
                           rec_nm, setup.anm_rec if setup.use_anm else 0)
    ligand = build_model(lig_struct, method, lig_active, lig_passive,
                         lig_nm, setup.anm_lig if setup.use_anm else 0)

    try:
        swarm_id = parse_swarm_id(positions_path)
    except ValueError:
        swarm_id = None

    return Simulation(
        setup=setup,
        method=method,
        receptor=receptor,
        ligand=ligand,
        positions=parse_positions(positions_path),
        swarm_id=swarm_id,
    )
