"""What every scoring method shares, plainly: the molecules as read from
their files, the pose transform, and the restraint and membrane bias.

The pose transform, as lightdock-rust applies it inside each energy
(``dfire.rs:274-320``, ``dna.rs:418-464``): the receptor never rotates, its
atoms move by their ANM modes alone, x + sum_k c_k m_k; the ligand's atoms
are rotated and translated, R(q) x + t, then moved by their modes, + sum_k
c_k m_k.  R is the matrix of q v q^-1 divided by |q|^2, as LightDock writes
it.  The coefficients of a pose are the receptor's ``anm_rec`` first, then
the ligand's.

The bias: a score s becomes s (1 + f_r + f_l) - 999 m, with f_r and f_l the
shares of each side's active restraint residues with an atom in contact
with the other side, and m the share of membrane beads (``MMB`` ``BJ``
atoms) in contact with the ligand.  What counts as contact is the
method's.  Nothing here reads anything a program under test has made.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

MEMBRANE_PENALTY = 999.0


def read_pdb(path):
    """(residue names, atom names, residue ids, coordinates (N, 3)) of the
    ATOM and HETATM records, by LightDock's fixed columns."""
    res_names, atom_names, res_ids, xyz = [], [], [], []
    for line in pathlib.Path(path).read_text().splitlines():
        if line[:6] not in ("ATOM  ", "HETATM"):
            continue
        res = line[17:20].strip()
        res_names.append(res)
        atom_names.append(line[12:16].strip())
        res_ids.append(f"{line[21].strip()}.{res}.{line[22:26].strip()}{line[26].strip()}")
        xyz.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
    return res_names, atom_names, res_ids, np.asarray(xyz, dtype=np.float64)


class Side:
    """One molecule: residue and atom names, coordinates, the atoms of each
    active restraint residue, the membrane beads, and its ANM modes (K, N,
    3), read from ``modes`` (a ``.npy`` file of K x N x 3 values) where it
    is given, else none."""

    def __init__(self, pdb_path, restraints=(), modes=None):
        self.res_names, self.atom_names, res_ids, self.xyz = read_pdb(pdb_path)
        n = len(self.xyz)
        self.restraints = [np.array([i for i, r in enumerate(res_ids) if r == rid])
                           for rid in sorted(set(restraints)) if rid in res_ids]
        self.membrane = np.array([i for i, (r, a) in enumerate(zip(self.res_names,
                                                                   self.atom_names))
                                  if r == "MMB" and a == "BJ"], dtype=np.int64)
        self.modes = (np.load(modes).astype(np.float64).reshape(-1, n, 3) if modes is not None
                      else np.zeros((0, n, 3)))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(P, 3, 3) matrices of q v q^-1 for quaternions (P, 4) (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)
    return m / (w * w + x * x + y * y + z * z)[:, None, None]


class Poser:
    """The pose transform of ``lig`` against ``rec`` (two :class:`Side`) on
    ``device`` at ``dtype``."""

    def __init__(self, rec: Side, lig: Side, device, dtype):
        self.device, self.dtype = device, dtype
        self.rec = torch.as_tensor(rec.xyz, dtype=dtype, device=device)
        self.lig = torch.as_tensor(lig.xyz, dtype=dtype, device=device)
        self.rec_modes = torch.as_tensor(rec.modes, dtype=dtype, device=device)
        self.lig_modes = torch.as_tensor(lig.modes, dtype=dtype, device=device)
        self.n_rec_modes = rec.modes.shape[0]

    def tensor(self, x) -> torch.Tensor:
        """``x`` (a float64 array) on the device at the scorer's dtype."""
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(self.dtype)

    def place(self, t, q, anm=None):
        """(receptor (1 or P, Nr, 3), ligand (P, Nl, 3)) of poses t (P, 3), q
        (P, 4) and ANM coefficients ``anm`` (P, K_r + K_l); a rigid
        receptor keeps its one copy."""
        t, q = self.tensor(t), self.tensor(q)
        lig = torch.einsum("pij,nj->pni", rotation(q), self.lig) + t[:, None, :]
        rec = self.rec[None]
        if anm is not None and anm.shape[1] > 0:
            a = self.tensor(anm)
            k = self.n_rec_modes
            if k:
                rec = rec + torch.einsum("pk,knc->pnc", a[:, :k], self.rec_modes)
            if self.lig_modes.shape[0]:
                lig = lig + torch.einsum("pk,knc->pnc", a[:, k:], self.lig_modes)
        return rec, lig


def pair_d2(rec, lig):
    """(P, Nr, Nl) squared distances of every receptor and ligand atom pair."""
    return sum((lig[:, None, :, c] - rec[:, :, None, c]) ** 2 for c in range(3))


class Bias:
    """The restraint and membrane bias of ``rec`` and ``lig`` (two
    :class:`Side`) on ``device``."""

    def __init__(self, rec: Side, lig: Side, device):
        self.device = device
        self.rec_restraints = [torch.as_tensor(r, device=device) for r in rec.restraints]
        self.lig_restraints = [torch.as_tensor(r, device=device) for r in lig.restraints]
        self.membrane = torch.as_tensor(rec.membrane, device=device)

    def apply(self, score, contact):
        """``score`` (P,) biased by the (P, Nr, Nl) bool ``contact``."""
        fr, fl = self.fractions(contact)
        return score * (1.0 + fr + fl) - MEMBRANE_PENALTY * self.beads(contact)

    def bracket(self, base_lo, base_hi, sure, maybe):
        """The lowest and highest biased scores, as arrays, of a score
        within [``base_lo``, ``base_hi``] (P,) where the pairs of ``sure``
        are in contact and those of ``maybe`` may be."""
        shares = []
        for contact in (sure, maybe):
            fr, fl = self.fractions(contact)
            shares.append((fr + fl, self.beads(contact)))
        (f_lo, m_lo), (f_hi, m_hi) = shares
        base = torch.stack([base_lo, base_hi])
        factor = torch.stack([1.0 + f_lo + 0 * base_lo, 1.0 + f_hi + 0 * base_lo])
        corners = (base[:, None] * factor[None, :]).reshape(4, -1)
        lo = corners.min(0).values - MEMBRANE_PENALTY * (m_hi + 0 * base_lo)
        hi = corners.max(0).values - MEMBRANE_PENALTY * (m_lo + 0 * base_lo)
        return lo.cpu().numpy(), hi.cpu().numpy()

    def fractions(self, contact):
        """(f_r, f_l): the shares of each side's restraint residues with an
        atom in ``contact``."""
        return (self._share(self.rec_restraints, lambda idx: contact[:, idx, :]),
                self._share(self.lig_restraints, lambda idx: contact[:, :, idx]))

    def _share(self, residues, pick):
        if not residues:
            return torch.zeros((), dtype=torch.float64, device=self.device)
        hits = [pick(idx).flatten(1).any(dim=1) for idx in residues]
        return torch.stack(hits).double().mean(dim=0)

    def beads(self, contact):
        """The share of membrane beads in ``contact`` with the ligand."""
        if self.membrane.numel() == 0:
            return torch.zeros((), dtype=torch.float64, device=self.device)
        return contact[:, self.membrane, :].any(dim=2).double().mean(dim=1)
