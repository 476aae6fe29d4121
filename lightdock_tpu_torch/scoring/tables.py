"""Parameter-table loading for the scoring functions.

Copy of ``lightdock_tpu/scoring/tables.py``.  The JSON assets are read
where the JAX package keeps them, ``lightdock_tpu/scoring/data/`` (data,
not code: nothing of that package is imported).  They hold the DFIRE
residue/atom-type coding tables and the AMBER force-field tables (see
``scripts/extract_params.py`` for their provenance).
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

DATA_DIR = (pathlib.Path(__file__).resolve().parents[2]
            / "lightdock_tpu" / "scoring" / "data")


@functools.lru_cache(maxsize=None)
def dfire_tables() -> dict:
    t = json.loads((DATA_DIR / "dfire_tables.json").read_text())
    t["residue_index"] = {k: int(v) for k, v in t["residue_index"].items()}
    t["atom_slot"] = {k: int(v) for k, v in t["atom_slot"].items()}
    t["atomres"] = [list(map(int, row)) for row in t["atomres"]]
    t["dist_to_bins"] = np.asarray(t["dist_to_bins"], dtype=np.int64)
    return t


@functools.lru_cache(maxsize=None)
def amber_tables(method: str) -> dict:
    """AMBER tables for 'dna' or 'pydock' (pydock adds *-element wildcards)."""
    if method not in ("dna", "pydock"):
        raise ValueError(f"no AMBER tables for method {method!r}")
    return json.loads((DATA_DIR / f"{method}_tables.json").read_text())
