"""P5: the constructs of the gather-form loop one at a time.  Port of
``scripts/exp_bisect.py``.

On x (32, 256) from uniform(0.1, 200), with slot(v) = clip(trunc(2 sqrt(v)
- 1), 0, 31) (``ops.probes.gather_form``):

* ``bare_gather_32``: tab2[idx, l] with precomputed indices;
* ``computed_idx_gather``: tab2[slot(x), l];
* ``fori_dyn3dslice_64``: the sum over r < 64 of tab3[r, 0, l] (x 0 + 1);
* ``fori_gather_64``: the sum over r < 64 of
  tab3[r][clip(trunc(2 sqrt(x) - 1) + r % 2, 0, 31), l];
* ``vmem_53mb_touch``: x + tab_big[7, 0, l] with tab_big (1632, 32, 256)
  of zeros (53.5 MB);
* ``chain_fori_64``: the sum over r < 64 of the 20-step select chain over
  tab3[r] at thresholds (k + 1)^2 / 4, unmasked.
"""

from __future__ import annotations

import functools

import numpy as np

from . import form_variant
from .exp_gather2d import THRESH

P, L, NSLOT = 32, 256, 32
REPS = 64
BIG_R = 1632

form = functools.partial(form_variant, shape=(P, L))


def inputs(seed=0):
    """x, idx32, tab2, then tab3 (64, 32, L) from randn, drawn in that
    order from one seed, and tab_big zeros (float32)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.1, 200, (P, L))
    idx32 = rng.randint(0, 32, (P, L))
    tab2 = rng.randn(NSLOT, L)
    tab3 = rng.randn(REPS, NSLOT, L)
    return {"x": x, "idx32": idx32, "tab2": tab2, "tab3": tab3,
            "tab_big": np.zeros((BIG_R, NSLOT, L), np.float32)}




def variants(arrays):
    """The script's six probes, in its order."""
    xt = {"x": "x", "tab": "tab3"}
    return [
        form("bare_gather_32", "bare", {"idx": "idx32", "tab": "tab2"}),
        form("computed_idx_gather", "slot_gather", {"x": "x", "tab": "tab2"}),
        form("fori_dyn3dslice_64", "row_loop", xt, REPS),
        form("fori_gather_64", "parity_loop", xt, REPS),
        form("vmem_53mb_touch", "touch", {"x": "x", "tab": "tab_big"}, row=7),
        form("chain_fori_64", "chain_loop", xt, REPS, thresholds=THRESH),
    ]
