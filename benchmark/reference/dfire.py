"""DFIRE scoring of rigid poses, plainly, with a bracket for pairs on an edge.

A pose (t, q) moves the ligand: x' = R(q) x + t, with R the matrix of
q v q^-1 divided by |q|^2, as LightDock writes it.  For each receptor and
ligand atom pair within 15 A, d = |x_r - x'_l| gives the slot
trunc(2 d - 1) (clamped to 0..50), the slot its bin (``dist_to_bins`` - 1)
and the pair its value ``potential[type_r, type_l, bin]``; the flat table is
read with LightDock's stride of 20 bins, so bins past 19 spill into the
next type's row.  The score is ``(4.7 - 0.0157 sum) (1 + f_r + f_l) - 999
m``: f_r and f_l are the shares of each side's active restraint residues
with an atom within 2.45 A of the other side, m the share of membrane beads
(``MMB`` ``BJ`` atoms) within 2.45 A of the ligand.

A pair whose distance lies within ``EDGE_EPS`` of a slot edge, of the
cutoff or of the contact distance may fall on either side in a program
that computes the same pose in float32 (its distances part from these by
up to ~1.5e-5 A: rotated coordinates ~4e-6 A, a snapshot's 7-decimal
quaternion ~3e-6 A at 30 A), so :meth:`DfireScorer.score` returns, beside
the score at the exact distances, the lowest and highest scores that such
pairs allow.  Nothing here reads anything a program under test has made.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

TABLES = json.loads(pathlib.Path(__file__).with_name("dfire_tables.json").read_text())
N_TYPES = 169
STRIDE = 20          # bins a type pair takes in the flat table
N_SLOTS = 51
CUTOFF2 = 225.0
CUTOFF_SLOT = 29     # 2 * 15 - 1
CONTACT = 2.45       # (3.9 + 1) / 2
SCALE = 0.0157
OFFSET = 4.7
MEMBRANE_PENALTY = 999.0
EDGE_EPS = 5e-5      # A
CHUNK_PAIRS = 60_000_000  # atom pairs x poses a chunk (GB-sized temporaries)


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


def atom_types(res_names, atom_names) -> np.ndarray:
    """DFIRE's atom type of each atom (``atomres[residue][atom slot]``)."""
    residue_index, atom_slot, atomres = (TABLES["residue_index"], TABLES["atom_slot"],
                                         TABLES["atomres"])
    return np.array([atomres[int(residue_index[r])][int(atom_slot[r + a])]
                     for r, a in zip(res_names, atom_names)], dtype=np.int64)


def read_potential(path) -> np.ndarray:
    """The flat DFIRE table of a ``DCparams`` text file, one value a line."""
    values = np.array(pathlib.Path(path).read_text().split(), dtype=np.float64)
    n = N_TYPES * N_TYPES * STRIDE
    if values.size < n:
        raise ValueError(f"{path}: {values.size} values, expected {n}")
    return values[:n]


def table_by_bins(flat: np.ndarray) -> np.ndarray:
    """(169 * 169, 32): the value of each type pair at each bin, read from
    the flat table with the 20-bin stride; 0 past its end."""
    a = np.arange(N_TYPES)[:, None, None]
    b = np.arange(N_TYPES)[None, :, None]
    k = np.arange(32)[None, None, :]
    idx = (a * N_TYPES * STRIDE + b * STRIDE + k).reshape(N_TYPES * N_TYPES, 32)
    out = flat[np.minimum(idx, flat.size - 1)]
    out[idx >= flat.size] = 0.0
    return out


class Side:
    """One molecule: coordinates, DFIRE types, the atoms of each active
    restraint residue and the membrane beads."""

    def __init__(self, pdb_path, restraints=()):
        res_names, atom_names, res_ids, self.xyz = read_pdb(pdb_path)
        self.types = atom_types(res_names, atom_names)
        self.restraints = [np.array([i for i, r in enumerate(res_ids) if r == rid])
                           for rid in sorted(set(restraints)) if rid in res_ids]
        self.membrane = np.array([i for i, (r, a) in enumerate(zip(res_names, atom_names))
                                  if r == "MMB" and a == "BJ"], dtype=np.int64)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(P, 3, 3) matrices of q v q^-1 for quaternions (P, 4) (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)
    return m / (w * w + x * x + y * y + z * z)[:, None, None]


class DfireScorer:
    """Scores of rigid poses of ``lig`` against ``rec`` (two :class:`Side`)
    on ``device`` at ``dtype``, ``CHUNK_PAIRS`` atom pairs of poses at a
    time.  At float64 :meth:`score` also gives the bracket; at a lower
    precision it computes every step in that precision (the control)."""

    def __init__(self, rec: Side, lig: Side, potential: np.ndarray, device,
                 dtype=torch.float64):
        self.device, self.dtype, self.eps = device, dtype, EDGE_EPS
        self.rec = torch.as_tensor(rec.xyz, dtype=dtype, device=device)
        self.lig = torch.as_tensor(lig.xyz, dtype=dtype, device=device)
        self.table = torch.as_tensor(table_by_bins(potential), dtype=dtype,
                                     device=device).reshape(-1)
        self.bin_of_slot = torch.as_tensor(np.array(TABLES["dist_to_bins"]) - 1,
                                           dtype=torch.int64, device=device)
        self.row = (torch.as_tensor(rec.types, device=device)[:, None] * N_TYPES
                    + torch.as_tensor(lig.types, device=device)[None, :]) * 32
        self.rec_restraints = [torch.as_tensor(r, device=device) for r in rec.restraints]
        self.lig_restraints = [torch.as_tensor(r, device=device) for r in lig.restraints]
        self.membrane = torch.as_tensor(rec.membrane, device=device)
        self.per_chunk = max(1, CHUNK_PAIRS // (self.rec.shape[0] * self.lig.shape[0]))

    def score(self, t: np.ndarray, q: np.ndarray):
        """(score, low, high), each (P,) float64, of poses t (P, 3), q (P, 4)."""
        parts = [self._chunk(t[i:i + self.per_chunk], q[i:i + self.per_chunk])
                 for i in range(0, t.shape[0], self.per_chunk)]
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))

    def _chunk(self, t, q):
        dt = self.dtype
        t = torch.as_tensor(np.asarray(t, np.float64), device=self.device).to(dt)
        q = torch.as_tensor(np.asarray(q, np.float64), device=self.device).to(dt)
        lig = torch.einsum("pij,nj->pni", rotation(q), self.lig) + t[:, None, :]
        d2 = sum((lig[:, None, :, c] - self.rec[None, :, None, c]) ** 2 for c in range(3))
        d = torch.sqrt(d2)
        within = d2 <= CUTOFF2
        u = 2.0 * d - 1.0
        # A pose that is not a number reads past the table (and adds nothing).
        slot = torch.clamp(torch.trunc(torch.nan_to_num(u, nan=N_SLOTS)), 0, N_SLOTS - 1).to(torch.int64)
        value = self.table[self.row[None] + self.bin_of_slot[slot]]
        value = torch.where(within, value, torch.zeros((), dtype=dt, device=self.device))
        raw = value.sum(dim=(1, 2), dtype=dt).double()
        near = d2 <= CONTACT ** 2
        fr = self._share(self.rec_restraints, lambda idx: near[:, idx, :])
        fl = self._share(self.lig_restraints, lambda idx: near[:, :, idx])
        mem = self._membrane(near)
        score = (OFFSET - SCALE * raw) * (1.0 + fr + fl) - MEMBRANE_PENALTY * mem
        if dt != torch.float64:
            return (score.cpu().numpy(),) * 3
        return (score.cpu().numpy(),) + self._bracket(d, u, value, raw, within)

    def _share(self, residues, pick):
        """The share of ``residues`` (atom index tensors) with an atom whose
        entry of ``pick(idx)`` is true for some atom of the other side."""
        if not residues:
            return torch.zeros((), dtype=torch.float64, device=self.device)
        hits = [pick(idx).flatten(1).any(dim=1) for idx in residues]
        return torch.stack(hits).double().mean(dim=0)

    def _membrane(self, near):
        if self.membrane.numel() == 0:
            return torch.zeros((), dtype=torch.float64, device=self.device)
        return near[:, self.membrane, :].any(dim=2).double().mean(dim=1)

    def _bracket(self, d, u, value, raw, within):
        """The lowest and highest scores allowed when every pair within
        ``eps`` of an edge may fall on either side of it."""
        e = self.eps
        edge = torch.round(u)
        on_edge = (torch.abs(u - edge) < 2 * e) & (edge >= 1) & (edge <= CUTOFF_SLOT)
        p, r, l = torch.nonzero(on_edge, as_tuple=True)
        m = edge[p, r, l].to(torch.int64)
        row = self.row[r, l]
        below = self.table[row + self.bin_of_slot[m - 1]]
        above = self.table[row + self.bin_of_slot[m]]
        # Past the cutoff edge a pair adds nothing.
        above_or_out = torch.where(m == CUTOFF_SLOT, torch.zeros_like(above), above)
        options = torch.stack([below, above, above_or_out])
        now = value[p, r, l]
        low = torch.zeros_like(raw).index_add_(0, p, (options.min(0).values - now).double())
        high = torch.zeros_like(raw).index_add_(0, p, (options.max(0).values - now).double())
        raw_lo, raw_hi = raw + low, raw + high
        sure = d < CONTACT - e
        maybe = d <= CONTACT + e
        shares = []
        for contact in (sure, maybe):
            shares.append((self._share(self.rec_restraints, lambda idx: contact[:, idx, :])
                           + self._share(self.lig_restraints, lambda idx: contact[:, :, idx]),
                           self._membrane(contact)))
        (f_lo, m_lo), (f_hi, m_hi) = shares
        base = torch.stack([OFFSET - SCALE * raw_hi, OFFSET - SCALE * raw_lo])
        factor = torch.stack([1.0 + f_lo + 0 * raw, 1.0 + f_hi + 0 * raw])
        corners = (base[:, None] * factor[None, :]).reshape(4, -1)
        lo = corners.min(0).values - MEMBRANE_PENALTY * (m_hi + 0 * raw)
        hi = corners.max(0).values - MEMBRANE_PENALTY * (m_lo + 0 * raw)
        return lo.cpu().numpy(), hi.cpu().numpy()
