"""P2: the pieces of a gather-form DFIRE inner loop.  Port of
``scripts/exp_gather2d.py``.

Poses p and ligand atoms l of lig (P, 3, L), a loop over the receptor atoms
r of rec (R, 3) with a table (R, 32, L) that varies per r; per r, d2 by
direct difference, then (``ops.probes.receptor_loop``):

* ``slot``: the slot clip(trunc(2 sqrt(d2) - 1), 0, 31) as float, no
  gather (isolates the gather's cost);
* ``gather``: one gather tab[r, slot, l];
* ``chain``: the 20-step select chain over thresholds (k + 1)^2 / 4,
  masked to d2 <= 225.
"""

from __future__ import annotations

import numpy as np

from . import Variant

P, L, R = 128, 256, 512
NSLOT = 32
THRESH = tuple(((np.arange(1, 21) + 1.0) ** 2 / 4.0).tolist())
# The scripts draw coordinates from uniform(-20, 20), where almost every
# pair lies past 15.5 A (slot 31, every threshold passed).  From
# uniform(-6, 6) pair distances run from 0 to 20.8 A: every slot, every
# chain threshold and the 15 A cutoff are crossed.
COMPACT_SPAN = 6.0


def inputs(seed=5, *, P=P, L=L, R=R, span=20.0):
    """lig (P, 3, L) and rec (R, 3) from uniform(-span, span), tab (R, 32,
    L) from randn, drawn in that order from one seed, float64."""
    rng = np.random.RandomState(seed)
    lig = rng.uniform(-span, span, (P, 3, L))
    rec = rng.uniform(-span, span, (R, 3))
    return {"lig": lig, "rec": rec, "tab": rng.randn(R, NSLOT, L)}


def loop_variants(arrays, names):
    """One receptor_loop variant per (name, mode) in ``names``; work is
    P L R pairs."""
    p, _, l = arrays["lig"].shape
    work = p * l * arrays["rec"].shape[0]
    return [Variant(name, "receptor_loop", {"lig": "lig", "rec": "rec", "tab": "tab"},
                    {"thresholds": THRESH, "mode": mode}, work)
            for name, mode in names]


def variants(arrays):
    """slot, gather and chain, in the script's order."""
    return loop_variants(arrays, [("slot", "slot"), ("gather", "gather"), ("chain", "chain")])
