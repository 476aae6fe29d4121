"""P6: the single operations of the gather-form loop.  Port of
``scripts/exp_probe_ops.py``.

On x (16, 256) from uniform(0.1, 200), with slot(v) = clip(trunc(2 sqrt(v)
- 1), 0, 31) (``ops.probes.gather_form``):

* ``sqrt``: sqrt(x);
* ``trunc_cast``: slot(x) as float;
* ``gather_static_tab``: tab[slot(x), l];
* ``gather_dyn_tab``: tab3[2][slot(x), l];
* ``smem_scalar_loop``: the sum over r < 8 of x - rec[r, 0];
* ``fori_dyn_gather``: the sum over r < 8 of tab3[r][slot(x + r), l];
* ``where_chain20``: the 20-step select chain over tab at thresholds
  (k + 2)^2 / 4, k < 20, unmasked.
"""

from __future__ import annotations

import functools

import numpy as np

from . import form_variant
from .exp_gather2d import THRESH

P, L = 16, 256
REPS = 8

form = functools.partial(form_variant, shape=(P, L))


def inputs(seed=0):
    """x, tab (32, L), tab3 (8, 32, L) from randn and rec (8, 3) from
    uniform(-5, 5), drawn in that order from one seed."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.1, 200, (P, L))
    tab = rng.randn(32, L)
    tab3 = rng.randn(REPS, 32, L)
    return {"x": x, "tab": tab, "tab3": tab3, "rec": rng.uniform(-5, 5, (REPS, 3))}




def variants(arrays):
    """The script's seven probes, in its order."""
    return [
        form("sqrt", "sqrt", {"x": "x"}),
        form("trunc_cast", "trunc_cast", {"x": "x"}),
        form("gather_static_tab", "slot_gather", {"x": "x", "tab": "tab"}),
        form("gather_dyn_tab", "slot_gather", {"x": "x", "tab": "tab3"}, row=2),
        form("smem_scalar_loop", "scalar_loop", {"x": "x", "rec": "rec"}, REPS),
        form("fori_dyn_gather", "slice_loop", {"x": "x", "tab": "tab3"}, REPS),
        form("where_chain20", "chain_loop", {"x": "x", "tab": "tab"}, thresholds=THRESH),
    ]
