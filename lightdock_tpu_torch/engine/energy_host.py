"""Single-pose scoring oracle at float64, on a torch device.

Port of ``lightdock_tpu/engine/energy_host.py``: one pose's energy with the
reference scoring functions' semantics (DFIRE reference
src/dfire.rs:264-362; DNA src/dna.rs:410-529; PYDOCK src/pydock.rs:426-543,
whose energy body is DNA's).  The pair terms are float64 tensors on
``device`` (the card unless the caller asks for the CPU); the restraint and
membrane bias reads the two interface masks on the host, as the original
does.  The pair sums run in torch's order, not NumPy's pairwise one, so a
score may differ from the original's in the last few ulps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops import quaternion as qt
from ..scoring import potentials, tables
from ..scoring.models import DockingModel


def pose_transform(coords, nmodes, anm_coefs=None, translation=None, rotation=None):
    """The reference pose transform of one structure's coordinates
    (reference src/dfire.rs:274-320), all tensors on one device.

    Ligand: rotate by the quaternion, translate, then add the ANM
    displacement sum; receptor (``rotation`` None): the ANM sum only.
    ``nmodes`` is (K, N, 3); ``anm_coefs`` (K,) or None."""
    if rotation is not None:
        coords = qt.rotate(rotation, coords) + translation
    if nmodes.shape[0] > 0 and anm_coefs is not None and anm_coefs.numel() > 0:
        coords = coords + torch.tensordot(anm_coefs, nmodes, dims=([0], [0]))
    return coords


def satisfied_restraints(interface: np.ndarray, restraints: dict) -> float:
    """Fraction of restraint residues with >=1 interface atom
    (reference src/scoring.rs:21-36)."""
    if not restraints:
        return 0.0
    hit = 0
    for atom_idx in restraints.values():
        if interface[np.asarray(atom_idx, dtype=np.int64)].any():
            hit += 1
    return hit / len(restraints)


def membrane_intersection(interface: np.ndarray, membrane: np.ndarray) -> float:
    """Fraction of membrane beads in the interface (reference
    src/scoring.rs:38-47)."""
    if membrane.size == 0:
        return 0.0
    return float(interface[membrane].sum()) / membrane.size


def _bias(score: float, rec_model: DockingModel, lig_model: DockingModel,
          iface_rec: np.ndarray, iface_lig: np.ndarray) -> float:
    perc_rec = satisfied_restraints(iface_rec, rec_model.active_restraints)
    perc_lig = satisfied_restraints(iface_lig, lig_model.active_restraints)
    penalty = 0.0
    intersection = membrane_intersection(iface_rec, rec_model.membrane)
    if intersection > 0.0:
        penalty = C.MEMBRANE_PENALTY_SCORE * intersection
    return score + perc_rec * score + perc_lig * score - penalty


def _model_tensors(model: DockingModel, device) -> dict:
    """A model's arrays as float64 (atom types int64) tensors; no modes
    where ``num_anm`` is 0."""
    def conv(x, dtype=torch.float64):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=dtype,
                                                      device=device)
    nmodes = model.nmodes if model.num_anm > 0 else np.zeros((0, model.num_atoms, 3))
    return {"coords": conv(model.coordinates), "nmodes": conv(nmodes),
            "types": conv(model.atom_types, torch.int64), "ele": conv(model.ele_charges),
            "vdw_c": conv(model.vdw_charges), "vdw_r": conv(model.vdw_radii)}


@dataclasses.dataclass
class HostScorer:
    """Two docking models and a method's parameters; ``energy`` scores one
    pose.  ``device`` is where the pair terms run: the CUDA card by default
    (``engine.runner.cuda_device``: an error without one), or the CPU."""

    method: str
    receptor: DockingModel
    ligand: DockingModel
    use_anm: bool
    potential: Optional[np.ndarray] = None   # DFIRE flat table
    dist_to_bins: Optional[np.ndarray] = None
    device: Any = "cuda"

    def __post_init__(self):
        from .runner import cuda_device

        if self.method == "dfire":
            if self.potential is None:
                self.potential = potentials.load_potential()
            if self.dist_to_bins is None:
                self.dist_to_bins = tables.dfire_tables()["dist_to_bins"]
        self.device = cuda_device(self.device, "HostScorer")
        self._rec = _model_tensors(self.receptor, self.device)
        self._lig = _model_tensors(self.ligand, self.device)
        if self.method == "dfire":
            self._potential = torch.as_tensor(np.asarray(self.potential, dtype=np.float64),
                                              device=self.device)
            self._dist_to_bins = torch.as_tensor(np.asarray(self.dist_to_bins),
                                                 dtype=torch.int64, device=self.device)

    def _tensor(self, x):
        return None if x is None else torch.as_tensor(np.asarray(x, dtype=np.float64),
                                                      device=self.device)

    def transformed_coordinates(self, translation, rotation, rec_nmodes, lig_nmodes):
        """(receptor (Nr, 3), ligand (Nl, 3)) float64 tensors on ``device``."""
        rec = pose_transform(self._rec["coords"], self._rec["nmodes"],
                             self._tensor(rec_nmodes) if self.use_anm else None)
        lig = pose_transform(self._lig["coords"], self._lig["nmodes"],
                             self._tensor(lig_nmodes) if self.use_anm else None,
                             self._tensor(translation), self._tensor(rotation))
        return rec, lig

    def energy(self, translation, rotation, rec_nmodes=None, lig_nmodes=None) -> float:
        rec, lig = self.transformed_coordinates(translation, rotation, rec_nmodes, lig_nmodes)
        diff = rec[:, None, :] - lig[None, :, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        if self.method == "dfire":
            score, close = self._dfire(d2)
        else:
            score, close = self._elec_vdw(d2)
        return _bias(float(score), self.receptor, self.ligand,
                     close.any(dim=1).cpu().numpy(), close.any(dim=0).cpu().numpy())

    # -- DFIRE -------------------------------------------------------------
    def _dfire(self, d2):
        mask = d2 <= C.DFIRE_DIST_CUTOFF2
        d = torch.where(mask, torch.sqrt(d2), torch.zeros_like(d2)) * 2.0 - 1.0
        # Rust `d as usize`: truncation toward zero with negative saturation
        # to 0 (reference src/dfire.rs:337).
        slot = torch.clamp(torch.trunc(d), 0, self._dist_to_bins.shape[0] - 1).to(torch.int64)
        bins = self._dist_to_bins[slot] - 1
        idx = (self._rec["types"][:, None] * (C.DFIRE_NUM_ATOM_TYPES * C.DFIRE_NUM_BINS)
               + self._lig["types"][None, :] * C.DFIRE_NUM_BINS + bins)
        contrib = self._potential[idx]
        score = torch.where(mask, contrib, torch.zeros_like(contrib)).sum()
        score = (score * C.DFIRE_SCALE - C.DFIRE_OFFSET) * -1.0
        # Interface on the *scaled* distance d (reference src/dfire.rs:339).
        return score, mask & (d <= C.INTERFACE_CUTOFF)

    # -- DNA / PYDOCK ------------------------------------------------------
    def _elec_vdw(self, d2):
        """Unguarded like the reference: at d2 == 0 the elec term clamps
        (or is 0/0) and vdw goes NaN through inf - inf; both clamps keep a
        NaN."""
        rec, lig = self._rec, self._lig
        elec = (rec["ele"][:, None] * lig["ele"][None, :]) / d2
        elec = torch.clamp(elec, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF)
        total_elec = torch.where(d2 <= C.ELEC_DIST_CUTOFF2, elec,
                                 torch.zeros_like(elec)).sum()

        vdw_energy = torch.sqrt(rec["vdw_c"][:, None] * lig["vdw_c"][None, :])
        vdw_radius = rec["vdw_r"][:, None] + lig["vdw_r"][None, :]
        p6 = vdw_radius ** 6 / d2 ** 3
        k = torch.clamp(vdw_energy * (p6 * p6 - 2.0 * p6), max=C.VDW_CUTOFF)
        total_vdw = torch.where(d2 <= C.VDW_DIST_CUTOFF2, k, torch.zeros_like(k)).sum()

        total_elec = total_elec * C.FACTOR / C.EPSILON
        return (total_elec + total_vdw) * -1.0, d2 <= C.INTERFACE_CUTOFF2
