"""DNA scoring (electrostatics and Lennard-Jones), plainly, with a bracket
for pairs on an edge.

Typing, as lightdock-rust's ``dna.rs:314-356``: an atom ``RES-NAME`` takes
its AMBER type from ``amber_types`` (an ``H1``, ``H2`` or ``H3`` missing
there is looked up as ``RES-H``), its well depth eps and radius r from the
type, and its charge q from ``ele_charges``, else ``nt_ele_charges``; an
atom found in none raises.  The tables are a copy of the AMBER tables
LightDock's DNA scoring reads (``dna_tables.json``).

Energy, as ``dna.rs:471-514``, over every receptor and ligand atom pair
placed as ``reference.pose`` says, d2 their squared distance:
electrostatics q_i q_j / d2 clamped to [-eps / 332, eps / 332] (eps = 4)
where d2 <= 900; Lennard-Jones sqrt(eps_i eps_j) (p6^2 - 2 p6), p6 =
((r_i + r_j)^2 / d2)^3, at most 1, where d2 <= 100; an atom is in contact
where d2 <= 15.21 (3.9 A).  The score is -(elec 332 / 4 + vdw) under the
bias of ``reference.pose``.

A pair whose distance lies within ``EDGE_EPS`` of 30 A, 10 A or 3.9 A may
fall on either side in a program that computes the same pose in float32,
so :meth:`DnaScorer.score` returns, beside the score at the exact
distances, the lowest and highest scores such pairs allow.  Nothing here
reads anything a program under test has made.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .pose import Bias, Poser, Side, pair_d2

TABLES = json.loads(pathlib.Path(__file__).with_name("dna_tables.json").read_text())
EPSILON = 4.0
FACTOR = 332.0
ELEC_CUTOFF = 30.0
VDW_CUTOFF = 10.0
CONTACT = 3.9
ELEC_CLAMP = EPSILON / FACTOR
VDW_CLAMP = 1.0
EDGE_EPS = 5e-5           # A, as DFIRE's
CHUNK_PAIRS = 60_000_000  # atom pairs x poses a chunk (GB-sized temporaries)


def amber_parameters(res_names, atom_names):
    """(charges, well depths, radii), each (N,) float64, of the atoms."""
    types, charges, nt_charges = (TABLES["amber_types"], TABLES["ele_charges"],
                                  TABLES["nt_ele_charges"])
    q, eps, r = [], [], []
    for res, name in zip(res_names, atom_names):
        atom = f"{res}-{name}"
        if atom not in types and name in ("H1", "H2", "H3"):
            atom = f"{res}-H"
        if atom not in types:
            raise ValueError(f"DNA: atom {atom!r} not supported")
        if atom in charges:
            q.append(charges[atom])
        elif atom in nt_charges:
            q.append(nt_charges[atom])
        else:
            raise ValueError(f"DNA: no charge for atom {atom!r}")
        eps.append(TABLES["vdw_charges"][types[atom]])
        r.append(TABLES["vdw_radii"][types[atom]])
    return (np.array(q, dtype=np.float64), np.array(eps, dtype=np.float64),
            np.array(r, dtype=np.float64))


class DnaScorer:
    """Scores of poses of ``lig`` against ``rec`` (two ``reference.pose.Side``)
    on ``device`` at ``dtype``, ``CHUNK_PAIRS`` atom pairs of poses at a
    time.  At float64 :meth:`score` also gives the bracket; at a lower
    precision it computes every step in that precision (the control)."""

    def __init__(self, rec: Side, lig: Side, device, dtype=torch.float64):
        self.device, self.dtype, self.eps = device, dtype, EDGE_EPS
        self.poser = Poser(rec, lig, device, dtype)
        self.bias = Bias(rec, lig, device)
        (q_r, e_r, r_r), (q_l, e_l, r_l) = (
            [torch.as_tensor(x, dtype=dtype, device=device)
             for x in amber_parameters(s.res_names, s.atom_names)] for s in (rec, lig))
        self.qq = q_r[:, None] * q_l[None, :]
        self.well = torch.sqrt(e_r[:, None] * e_l[None, :])
        self.radius = r_r[:, None] + r_l[None, :]
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
        zero = torch.zeros((), dtype=dt, device=self.device)
        d2 = pair_d2(*self.poser.place(t, q, anm))
        elec = torch.clamp(self.qq[None] / d2, -ELEC_CLAMP, ELEC_CLAMP)
        p2 = self.radius[None] * self.radius[None] / d2
        p6 = p2 * p2 * p2
        vdw = torch.clamp(self.well[None] * (p6 * p6 - 2.0 * p6), max=VDW_CLAMP)
        elec_in = torch.where(d2 <= ELEC_CUTOFF ** 2, elec, zero)
        vdw_in = torch.where(d2 <= VDW_CUTOFF ** 2, vdw, zero)
        raw = (elec_in.sum(dim=(1, 2), dtype=dt).double() * (FACTOR / EPSILON)
               + vdw_in.sum(dim=(1, 2), dtype=dt).double())
        score = self.bias.apply(-raw, d2 <= CONTACT ** 2)
        if dt != torch.float64:
            return (score.cpu().numpy(),) * 3
        d = torch.sqrt(d2)
        low, high = torch.zeros_like(raw), torch.zeros_like(raw)
        # A pair on a cutoff's edge adds its value or nothing.
        for cutoff, value, now, weight in ((ELEC_CUTOFF, elec, elec_in, FACTOR / EPSILON),
                                           (VDW_CUTOFF, vdw, vdw_in, 1.0)):
            p, r, l = torch.nonzero(torch.abs(d - cutoff) < self.eps, as_tuple=True)
            v, n = value[p, r, l], now[p, r, l]
            low.index_add_(0, p, weight * (torch.minimum(v, zero) - n))
            high.index_add_(0, p, weight * (torch.maximum(v, zero) - n))
        e = self.eps
        return (score.cpu().numpy(),) + self.bias.bracket(-(raw + high), -(raw + low),
                                                          d < CONTACT - e, d <= CONTACT + e)
