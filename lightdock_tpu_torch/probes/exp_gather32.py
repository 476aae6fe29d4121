"""P3: the gather-form DFIRE inner loop at the shapes of the 1ppe complex.
Port of ``scripts/exp_gather32.py``.

P2's receptor loop at P = 32 poses, L = 256 ligand atoms and R = 1632
receptor atoms (1ppe's padded receptor and ligand; the (R, 32, L) table is
53.5 MB):

* ``v3gather``: per r, the slot clip(trunc(2 sqrt(d2) - 1), 0, 31) and one
  gather tab[r, slot, l];
* ``v2chain``: the same loop with the 20-step select chain, masked to
  d2 <= 225 (v2's arithmetic).
"""

from __future__ import annotations

from . import exp_gather2d

P, L, R, NSLOT = 32, 256, 1632, 32
THRESH = exp_gather2d.THRESH


def inputs(seed=5, *, P=P, L=L, R=R, span=20.0):
    """lig, rec and tab as P2 draws them, at these shapes."""
    return exp_gather2d.inputs(seed, P=P, L=L, R=R, span=span)


def variants(arrays):
    """v3gather and v2chain, in the script's order."""
    return exp_gather2d.loop_variants(arrays, [("v3gather", "gather"), ("v2chain", "chain")])
