"""DFIRE pairwise-potential table handling.

Copy of ``lightdock_tpu/scoring/potentials.py`` (``synthetic_potential``,
``load_potential``, ``potential_by_bins``).  The real DFIRE table is the
169*169*20-line text file ``DCparams`` of the reference's ``data/`` folder,
resolved from ``$LIGHTDOCK_DATA`` or ``./data``; without it a deterministic
synthetic table stands in, self-consistent but not comparable to published
DFIRE energies.
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np

from ..constants import DFIRE_NUM_ATOM_TYPES, DFIRE_NUM_BINS

TABLE_SIZE = DFIRE_NUM_ATOM_TYPES * DFIRE_NUM_ATOM_TYPES * DFIRE_NUM_BINS  # 571220

_warned = False


def dfire_data_path() -> pathlib.Path:
    folder = os.environ.get("LIGHTDOCK_DATA", "data")
    return pathlib.Path(folder) / "DCparams"


def synthetic_potential() -> np.ndarray:
    """Deterministic stand-in table (seeded; same values on every host)."""
    rng = np.random.RandomState(0xDC0DE)
    pot = rng.standard_normal(TABLE_SIZE) * 0.5
    # Mimic the real table's sentinel-ish large head value ("10.0" at [0]).
    pot[0] = 10.0
    return pot.astype(np.float64)


def load_potential(path=None, allow_synthetic: bool = True) -> np.ndarray:
    """Load the flat (571220,) DFIRE potential.

    Resolution order: explicit ``path`` -> ``$LIGHTDOCK_DATA/DCparams`` ->
    ``./data/DCparams`` -> synthetic fallback (with a one-time warning).
    A parsed ``.npy`` cache is written beside the text file when possible.
    """
    global _warned
    p = pathlib.Path(path) if path is not None else dfire_data_path()
    if p.exists():
        cache = p.with_suffix(".npy")
        if cache.exists() and cache.stat().st_mtime >= p.stat().st_mtime:
            pot = np.load(cache)
            if pot.shape == (TABLE_SIZE,):
                return pot
        values = np.loadtxt(p, dtype=np.float64)[:TABLE_SIZE]
        if values.shape[0] < TABLE_SIZE:
            raise ValueError(
                f"DFIRE table at {p} has {values.shape[0]} entries, expected {TABLE_SIZE}")
        try:
            np.save(cache, values)
        except OSError:
            pass
        return values
    if not allow_synthetic:
        raise FileNotFoundError(f"DFIRE potential not found at {p}")
    if not _warned:
        print(
            f"lightdock_tpu_torch: DFIRE table not found at {p}; using the "
            "deterministic synthetic table (set LIGHTDOCK_DATA for real scores)",
            file=sys.stderr,
        )
        _warned = True
    return synthetic_potential()


def potential_by_bins(pot_flat: np.ndarray, num_bins: int = 32) -> np.ndarray:
    """Re-index the flat table as [atoma, atomb, bin] with spill semantics.

    The reference indexes ``flat[atoma*169*20 + atomb*20 + bin]`` where
    ``bin`` can reach 31, spilling past the 20-entry stride into the next
    atom-type row (reference src/dfire.rs:337-338).  This materialises that
    exact lookup as a dense (169, 169, num_bins) table.  Out-of-range flat
    indexes (only reachable for the last atom-type pairs) are filled with 0.
    """
    n = DFIRE_NUM_ATOM_TYPES
    a = np.arange(n)[:, None, None]
    b = np.arange(n)[None, :, None]
    k = np.arange(num_bins)[None, None, :]
    idx = a * (n * DFIRE_NUM_BINS) + b * DFIRE_NUM_BINS + k
    safe = np.clip(idx, 0, TABLE_SIZE - 1)
    out = pot_flat[safe]
    out[idx >= TABLE_SIZE] = 0.0
    return out
