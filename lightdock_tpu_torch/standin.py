"""Stand-in complexes made from a seed, for the GPU smoke run and the tests.

The real inputs (PDB files, membrane beads, ANM modes, the DCparams table)
are not in the repository, so each configuration is built from random
atoms of the right counts with the deterministic synthetic DFIRE table.

* :func:`toy_system` reproduces the arrays of ``__graft_entry__``'s
  ``_toy_system`` from the same seed, draw for draw: atoms uniform
  in a 40 A cube, one active restraint on each side, poses within 10 A of
  the receptor's centre.  Every tile pair is active in that geometry.
* :func:`membrane_system` is the 1k4c-shaped DFIRE membrane complex: a slab
  of receptor atoms flagged as membrane beads and one swarm's poses next
  to the receptor's surface, so that part of the tile grid is culled.
"""

from __future__ import annotations

import numpy as np

from .engine.params import build_batch_params
from .scoring.models import DockingModel
from .scoring.potentials import synthetic_potential

# 1k4c: receptor 3413 atoms, ligand 3268 atoms (SURVEY.md, BENCH1K4C_r04.json).
K4C_ATOMS = (3413, 3268)
MEMBRANE_SLAB_Z = 12.0   # receptor atoms above this height are membrane beads
SWARM_DISTANCE = 40.0    # swarm centre from the receptor's centre, A
SWARM_RADIUS = 5.0       # translations lie within this of the swarm centre


def _model(rng, n, method, num_anm, membrane=None):
    kwargs = {}
    if method == "dfire":
        kwargs["atom_types"] = rng.randint(0, 168, size=n).astype(np.int32)
    else:
        kwargs.update(
            ele_charges=rng.uniform(-1, 1, size=n),
            vdw_charges=rng.uniform(0, 0.5, size=n),
            vdw_radii=rng.uniform(0.5, 2.5, size=n))
    coords = rng.uniform(-20, 20, size=(n, 3))
    return DockingModel(
        method=method,
        coordinates=coords,
        num_anm=num_anm,
        nmodes=(rng.standard_normal((num_anm, n, 3)) * 0.1
                if num_anm else np.zeros((0, n, 3))),
        membrane=(np.zeros(0, dtype=np.int64) if membrane is None
                  else np.nonzero(membrane(coords))[0].astype(np.int64)),
        active_restraints={"A.R.1": [0, 1]},
        passive_restraints={},
        **kwargs)


def toy_system(n_rec, n_lig, g, num_anm=0, seed=0, method="dfire",
               dfire_mode="auto"):
    """(params, positions (G, 7 + 2 num_anm), num_anm): random atoms in a
    40 A cube, f32, the DFIRE tables of ``dfire_mode`` (by default the v2
    kernel path's type-indexed ones; 'steps' for the v1 path), poses within
    10 A of the receptor's centre with random unit quaternions.  The mode
    changes no draw."""
    rng = np.random.RandomState(seed)
    rec = _model(rng, n_rec, method, num_anm)
    lig = _model(rng, n_lig, method, num_anm)
    params = build_batch_params(
        rec, lig, use_anm=num_anm > 0, dtype=np.float32,
        potential=synthetic_potential() if method == "dfire" else None,
        dfire_mode=dfire_mode)
    cols = [rng.uniform(-10, 10, (g, 3)), rng.standard_normal((g, 4))]
    if num_anm:
        cols += [rng.uniform(-1, 1, (g, num_anm)), rng.uniform(-1, 1, (g, num_anm))]
    pos = np.concatenate(cols, axis=1)
    pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
    return params, pos, num_anm


def membrane_system(g, n_rec=K4C_ATOMS[0], n_lig=K4C_ATOMS[1], seed=0):
    """(params, positions (G, 7)) of the 1k4c-shaped DFIRE membrane
    complex: no ANM, f32, random DFIRE types; each molecule uniform in a
    40 A cube (about protein density at 1k4c's atom counts); the receptor
    atoms above z = 12 A are membrane beads; translations within 5 A of the
    point 40 A above the receptor's centre, toward the membrane slab, with
    random unit quaternions."""
    rng = np.random.RandomState(seed)
    rec = _model(rng, n_rec, "dfire", 0,
                 membrane=lambda c: c[:, 2] > MEMBRANE_SLAB_Z)
    lig = _model(rng, n_lig, "dfire", 0)
    params = build_batch_params(rec, lig, use_anm=False, dtype=np.float32,
                                potential=synthetic_potential())
    direction = rng.standard_normal((g, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    radius = SWARM_RADIUS * rng.uniform(0, 1, g) ** (1.0 / 3.0)
    centre = rec.coordinates.mean(axis=0) + np.array([0.0, 0.0, SWARM_DISTANCE])
    t = centre + direction * radius[:, None]
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return params, np.concatenate([t, q], axis=1)
