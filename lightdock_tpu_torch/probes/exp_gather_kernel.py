"""P1: is a K-way table selection cheap?  Port of
``scripts/exp_gather_kernel.py``.

Candidate inner loops for DFIRE's per-pair selection among K = 21 table
entries, on (P, R, L) tiles of d2, ``REPS`` reps a call, rep i moving d2
by i 1e-6 (before the select and the d2 <= 225 mask), summed over reps and
(R, L) into (P, 1, 1):

* ``chain``: the 20-step select chain of deltas, tab[0] + the sum of
  tab[k + 1] over the thresholds s_k <= d2;
* ``tak``: the count of thresholds passed, then one indexed load of
  tab[count];
* ``tourn``: a binary tournament of selects, the same tab[count];
* ``chain16``: ``chain`` in bfloat16, rounded at every operation.

As in the script, ``chain`` computes another function than ``tak`` and
``tourn`` (a sum of deltas, not one entry); those two agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Variant

P, R, L = 8, 32, 256
K = 21
REPS = 400
THRESH = tuple(np.sort(np.random.RandomState(0).uniform(1, 225, K - 1)).tolist())


def inputs(seeds=(1, 2), *, P=P, R=R, L=L):
    """d2 (P, R, L) from uniform(0, 400) and tab (K, R, L) from randn, each
    from its own seed, float64 as drawn."""
    return {"d2": np.random.RandomState(seeds[0]).uniform(0, 400, (P, R, L)),
            "tab": np.random.RandomState(seeds[1]).randn(K, R, L)}


def variants(arrays, reps=REPS):
    """chain, tak, tourn (float32) and chain16 (bfloat16), in the script's
    order; work is P R L reps pair evaluations."""
    work = arrays["d2"].size * reps

    def select(name, mode, dtype=torch.float32):
        return Variant(name, "select_reps", {"d2": "d2", "tab": "tab"},
                       {"thresholds": THRESH, "mode": mode, "reps": reps}, work, dtype)

    return [select("chain", "chain"), select("tak", "tak"), select("tourn", "tourn"),
            select("chain16", "chain", torch.bfloat16)]
