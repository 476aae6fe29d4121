"""P4: forms of the slot gather.  Port of ``scripts/exp_gather_forms.py``.

On x (32, 256) from uniform(0.1, 200), with slot(v) = clip(trunc(2 sqrt(v)
- 1), 0, 31) (``ops.probes.gather_form``):

* ``bare_gather``: tab2[idx, l] with precomputed indices;
* ``computed_idx_gather``: tab2[slot(x), l];
* ``fori_static_tab_gather``: the sum over r < 64 of tab2[slot(x + r), l];
* ``fori_plload_gather`` and ``unrolled_static_slices``: the sum over
  r < 64 of tab3[r][slot(x + r), l].  The first sliced the table with
  ``pl.load``, which the installed JAX no longer has; it computes what the
  second computes.
"""

from __future__ import annotations

import functools

import numpy as np

from . import form_variant

P, L, NSLOT = 32, 256, 32
REPS = 64

form = functools.partial(form_variant, shape=(P, L))


def inputs(seed=0):
    """x, idx32 (randint(0, 32)), tab2 (32, L) and tab3 (64, 32, L) from
    randn, drawn in that order from one seed."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.1, 200, (P, L))
    idx32 = rng.randint(0, 32, (P, L))
    tab2 = rng.randn(NSLOT, L)
    return {"x": x, "idx32": idx32, "tab2": tab2, "tab3": rng.randn(REPS, NSLOT, L)}




def variants(arrays):
    """The script's five probes, in its order."""
    return [
        form("bare_gather", "bare", {"idx": "idx32", "tab": "tab2"}),
        form("computed_idx_gather", "slot_gather", {"x": "x", "tab": "tab2"}),
        form("fori_static_tab_gather", "static_loop", {"x": "x", "tab": "tab2"}, REPS),
        form("fori_plload_gather", "slice_loop", {"x": "x", "tab": "tab3"}, REPS),
        form("unrolled_static_slices", "slice_loop", {"x": "x", "tab": "tab3"}, REPS),
    ]
