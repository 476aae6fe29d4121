"""DFIRE scoring, plainly, with a bracket for pairs on an edge.

A pose (t, q and its ANM coefficients) places both molecules as
``reference.pose`` says.  For each receptor and ligand atom pair within
15 A, d = |x_r - x_l| gives the slot
trunc(2 d - 1) (clamped to 0..50), the slot its bin (``dist_to_bins`` - 1)
and the pair its value ``potential[type_r, type_l, bin]``; the flat table is
read with LightDock's stride of 20 bins, so bins past 19 spill into the
next type's row.  The score is ``4.7 - 0.0157 sum`` under the bias of
``reference.pose``, an atom in contact within 2.45 A of the other side.

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

from .pose import Bias, Poser, Side, pair_d2

TABLES = json.loads(pathlib.Path(__file__).with_name("dfire_tables.json").read_text())
N_TYPES = 169
STRIDE = 20          # bins a type pair takes in the flat table
N_SLOTS = 51
CUTOFF2 = 225.0
CUTOFF_SLOT = 29     # 2 * 15 - 1
CONTACT = 2.45       # (3.9 + 1) / 2
SCALE = 0.0157
OFFSET = 4.7
EDGE_EPS = 5e-5      # A
CHUNK_PAIRS = 60_000_000  # atom pairs x poses a chunk (GB-sized temporaries)


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


class DfireScorer:
    """Scores of poses of ``lig`` against ``rec`` (two ``reference.pose.Side``)
    on ``device`` at ``dtype``, ``CHUNK_PAIRS`` atom pairs of poses at a
    time.  At float64 :meth:`score` also gives the bracket; at a lower
    precision it computes every step in that precision (the control)."""

    def __init__(self, rec: Side, lig: Side, potential: np.ndarray, device,
                 dtype=torch.float64):
        self.device, self.dtype, self.eps = device, dtype, EDGE_EPS
        self.poser = Poser(rec, lig, device, dtype)
        self.bias = Bias(rec, lig, device)
        self.table = torch.as_tensor(table_by_bins(potential), dtype=dtype,
                                     device=device).reshape(-1)
        self.bin_of_slot = torch.as_tensor(np.array(TABLES["dist_to_bins"]) - 1,
                                           dtype=torch.int64, device=device)
        types = [torch.as_tensor(atom_types(s.res_names, s.atom_names), device=device)
                 for s in (rec, lig)]
        self.row = (types[0][:, None] * N_TYPES + types[1][None, :]) * 32
        self.per_chunk = max(1, CHUNK_PAIRS // (len(rec.xyz) * len(lig.xyz)))

    def score(self, t: np.ndarray, q: np.ndarray, anm=None):
        """(score, low, high), each (P,) float64, of poses t (P, 3), q (P, 4)
        and ANM coefficients ``anm`` (P, K) where the sides have modes."""
        parts = [self._chunk(t[i:i + self.per_chunk], q[i:i + self.per_chunk],
                             None if anm is None else anm[i:i + self.per_chunk])
                 for i in range(0, t.shape[0], self.per_chunk)]
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))

    def _chunk(self, t, q, anm):
        dt = self.dtype
        d2 = pair_d2(*self.poser.place(t, q, anm))
        d = torch.sqrt(d2)
        within = d2 <= CUTOFF2
        u = 2.0 * d - 1.0
        # A pose that is not a number reads past the table (and adds nothing).
        slot = torch.clamp(torch.trunc(torch.nan_to_num(u, nan=N_SLOTS)), 0, N_SLOTS - 1).to(torch.int64)
        value = self.table[self.row[None] + self.bin_of_slot[slot]]
        value = torch.where(within, value, torch.zeros((), dtype=dt, device=self.device))
        raw = value.sum(dim=(1, 2), dtype=dt).double()
        score = self.bias.apply(OFFSET - SCALE * raw, d2 <= CONTACT ** 2)
        if dt != torch.float64:
            return (score.cpu().numpy(),) * 3
        return (score.cpu().numpy(),) + self._bracket(d, u, value, raw)

    def _bracket(self, d, u, value, raw):
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
        return self.bias.bracket(OFFSET - SCALE * raw_hi, OFFSET - SCALE * raw_lo,
                                 d < CONTACT - e, d <= CONTACT + e)
