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
* :func:`write_complex` writes a stand-in complex as the files the command
  line reads: PDB files of named atoms, setup.json, positions files and
  the ANM ``.npy`` files.
* :func:`bin_edge_case` is no complex but the DFIRE pair kernels' inputs
  with every atom pair on a bin edge or a few ulps beside it;
  :func:`cutoff_edge_case` likewise for the elec/vdw kernels and their
  interface, vdw and elec cutoffs.
"""

from __future__ import annotations

import json
import pathlib
from typing import List, NamedTuple

import numpy as np
import torch

from . import constants as C
from .engine.params import build_batch_params, dfire_bin_thresholds
from .ops import dfire_pairs as dp
from .scoring import tables
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


# The 20 amino acids (the DFIRE residues but the membrane's MMB and MMY)
# and the four DNA nucleotides.
AMINO_ACIDS = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
               "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
NUCLEOTIDES = ("DA", "DC", "DG", "DT")


def _residue_templates(method: str, residues) -> List[tuple]:
    """(residue name, its atom names) for each of ``residues``, the names
    the method's tables type: DFIRE's ``atom_slot`` keys, AMBER's
    ``amber_types`` keys."""
    if method == "dfire":
        keys = [(k[:3], k[3:]) for k in tables.dfire_tables()["atom_slot"]]
    else:
        keys = [tuple(k.split("-", 1)) for k in tables.amber_tables(method)["amber_types"]]
    return [(res, [name for r, name in keys if r == res]) for res in residues]


def _pdb_lines(coords, templates, chain: str) -> List[str]:
    """ATOM records of ``coords`` (N, 3): residue k takes template k mod
    the count, its atoms in the template's order, until N atoms are
    written.  A name of four letters starts at column 12, shorter ones at
    13; coordinates are written %8.3f."""
    lines, k = [], 0
    while len(lines) < len(coords):
        res, names = templates[k % len(templates)]
        k += 1
        for name in names[:len(coords) - len(lines)]:
            x, y, z = coords[len(lines)]
            field = name if len(name) == 4 else f" {name:<3}"
            lines.append(f"ATOM  {len(lines) + 1:5d} {field} {res:>3} {chain}{k:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00")
    return lines


def write_complex(directory, method: str, n_rec: int, n_lig: int, g: int,
                  num_anm: int = 0, n_swarms: int = 1, seed: int = 0):
    """Write a stand-in complex as the command line's input files under
    ``directory``: ``lightdock_rec.pdb`` and ``lightdock_lig.pdb``,
    ``setup.json`` (``rec.pdb``/``lig.pdb``, ``seed``, ``use_anm``,
    ``anm_rec``, ``anm_lig``, the first residue of each side an active
    restraint), ``initial_positions_{i}.dat`` for ``i < n_swarms`` (G rows
    of 7 + 2 ``num_anm`` columns) and, with ``num_anm`` > 0,
    ``rec_nm.npy`` and ``lig_nm.npy`` (num_anm, N, 3).

    Drawn as :func:`toy_system` draws: atoms uniform in a 40 A cube, modes
    standard normal x 0.1, translations uniform in [-10, 10] (near the
    receptor's centre, so every tile pair stays active), random unit
    quaternions, ANM coefficients uniform in [-1, 1].  Atom names cycle
    through residue templates of the method's tables: for DFIRE the 20
    amino acids on both sides (chains A and B); for DNA and PYDOCK the
    amino acids on the receptor and the DNA nucleotides on the ligand.
    Returns (setup path, [positions paths])."""
    rng = np.random.RandomState(seed)
    root = pathlib.Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    rec = rng.uniform(-20, 20, size=(n_rec, 3))
    lig = rng.uniform(-20, 20, size=(n_lig, 3))
    lig_residues = AMINO_ACIDS if method == "dfire" else NUCLEOTIDES
    sides = (("rec", rec, _residue_templates(method, AMINO_ACIDS), "A"),
             ("lig", lig, _residue_templates(method, lig_residues), "B"))
    restraints = {}
    for name, coords, templates, chain in sides:
        lines = _pdb_lines(coords, templates, chain)
        (root / f"{C.DEFAULT_LIGHTDOCK_PREFIX}{name}.pdb").write_text(
            "\n".join(lines + ["END"]) + "\n")
        restraints[name] = {"active": [f"{chain}.{templates[0][0]}.1"],
                            "passive": [], "blocked": []}
    if num_anm:
        for nm_file, n in ((C.DEFAULT_REC_NM_FILE, n_rec), (C.DEFAULT_LIG_NM_FILE, n_lig)):
            np.save(root / nm_file, rng.standard_normal((num_anm, n, 3)) * 0.1)
    setup = root / "setup.json"
    setup.write_text(json.dumps({
        "receptor_pdb": "rec.pdb", "ligand_pdb": "lig.pdb", "seed": C.DEFAULT_SEED,
        "use_anm": num_anm > 0, "anm_rec": num_anm, "anm_lig": num_anm,
        "swarms": n_swarms, "glowworms": g,
        "receptor_restraints": restraints["rec"],
        "ligand_restraints": restraints["lig"]}, indent=2))
    paths = []
    for i in range(n_swarms):
        cols = [rng.uniform(-10, 10, (g, 3)), rng.standard_normal((g, 4))]
        if num_anm:
            cols += [rng.uniform(-1, 1, (g, num_anm)), rng.uniform(-1, 1, (g, num_anm))]
        pos = np.concatenate(cols, axis=1)
        pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
        path = root / f"initial_positions_{i}.dat"
        path.write_text("".join(" ".join(repr(float(v)) for v in row) + "\n"
                                for row in pos))
        paths.append(path)
    return setup, paths


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


class BinEdgeCase(NamedTuple):
    args: tuple          # (rec_all, lig_all, DfireTables, active_chunks, iface_active)
    kwargs: dict         # r_tile, l_tile, need_iface, near_chunks
    d2: np.ndarray       # (G,) float32: the squared distance of pose g's pairs
    rec_half: torch.Tensor    # (K, Nr, T) the tables are built from
    lig_onehot: torch.Tensor  # (T, Nl)
    k4: tuple            # (args, kwargs) of ops.dfire_pairs_v1: the step tables


def edge_d2(ulps: int = 1) -> np.ndarray:
    """float32 squared distances on and within ``ulps`` ulps either side of
    every 0.5 A slot edge ((m + 1) / 2)^2 up to the 225 cutoff (which
    includes every live DFIRE threshold) and of the interface cutoff
    2.45^2, and 0."""
    edges = [(s / 2.0) ** 2 for s in range(1, 31)] + [dp.IFACE2]
    return np.concatenate([np.float32([0.0]), _ulps_around(edges, ulps)])


def _ulps_around(values, ulps):
    """Each of ``values`` as float32, and the float32 values within
    ``ulps`` ulps either side of it."""
    bits = np.array(values, dtype=np.float32).view(np.int32)
    near = bits[:, None] + np.arange(-ulps, ulps + 1, dtype=np.int32)[None, :]
    return near.reshape(-1).view(np.float32)


def _offset_at(target):
    """(x, y) float32 with ((x * x) + (y * y)) + 0 == target in float32,
    the kernels' d2 of a pair (x, y, 0) apart."""
    zero = np.float32(0.0)
    if target == 0:
        return zero, zero
    x = np.float32(np.sqrt(np.float64(target) * 0.999))
    xx = x * x
    y = np.float32(np.sqrt(np.float64(target) - np.float64(xx)))
    for _ in range(10000):
        d2 = (xx + y * y) + zero * zero
        if d2 == target:
            return x, y
        y = np.nextafter(y, np.float32(np.inf) if d2 < target else zero)
    raise RuntimeError(f"no float32 pair offset gives d2 = {target!r}")


def bin_edge_case(device="cpu", per_pose: bool = False, n_lig: int = 4,
                  ulps: int = 1) -> BinEdgeCase:
    """Inputs of the DFIRE pair kernels (``ops.dfire_pairs``; 32 x 128
    tiles) whose pairs sit on the bin edges: pose g puts its ``n_lig``
    ligand atoms (types 0 .. n_lig - 1) at squared distance
    ``edge_d2(ulps)[g]``
    from one receptor atom (row 5, or per pose row 7g mod 32 of a (G, Nr,
    3) receptor); every other pair is hundreds of A apart.  The table's
    entry for bin k is (k + 1) times a per-pair factor in [1, 1.75], so a
    pair binned one off moves its pose's sum by at least 1.  Every chunk
    and interface bit is set; no near bits.  ``k4`` holds the same pairs
    as the inputs of the step-form kernel K4: the step tables (K, Nr,
    n_lig) whose channels are each pair's factor (so the prefix sum at
    channel k is the table's entry for bin k), the thresholds, and every
    per-pose bit set."""
    d2 = edge_d2(ulps)
    g, nr = d2.shape[0], 32
    thresholds = dfire_bin_thresholds(tables.dfire_tables()["dist_to_bins"])
    thresholds = tuple(float(t) for t in thresholds if t <= C.DFIRE_DIST_CUTOFF2)
    rec, lig = _edge_geometry(d2, per_pose, n_lig, nr)
    k, t = len(thresholds), n_lig
    factor = 1.0 + 0.25 * ((np.arange(nr)[:, None] + np.arange(t)[None, :]) % 4)
    rec_half = torch.as_tensor(np.broadcast_to(factor, (k, nr, t)).astype(np.float32),
                               device=device)
    lig_onehot = torch.eye(t, n_lig, dtype=torch.float32, device=device)
    tab = dp.dfire_tables(rec_half, lig_onehot, thresholds, 32, 128)
    n_chunks = -(-g // dp.POSE_BLOCK)
    act = torch.ones((1, 1, n_chunks), dtype=torch.int32, device=device)
    iface = torch.ones((1, 1, g), dtype=torch.int32, device=device)
    args = (torch.as_tensor(rec, device=device), torch.as_tensor(lig, device=device),
            tab, act, iface)
    kwargs = dict(r_tile=32, l_tile=128, need_iface=True, near_chunks=None)
    ones = torch.ones((1, 1, g), dtype=torch.int32, device=device)
    dq = torch.matmul(rec_half, lig_onehot).contiguous()   # (K, Nr, n_lig), exact
    k4 = ((args[0], args[1], dq, thresholds, ones, ones),
          dict(r_tile=32, l_tile=128, need_iface=True))
    return BinEdgeCase(args, kwargs, d2, rec_half, lig_onehot, k4)


class CutoffEdgeCase(NamedTuple):
    k3: tuple            # (args, kwargs) of ops.elec_vdw_pairs (chunk bits)
    k5: tuple            # (args, kwargs) of ops.elec_vdw_pairs_v1 (per-pose bits)
    d2: np.ndarray       # (G,) float32: the squared distance of pose g's pairs


def _edge_geometry(d2, per_pose, n_lig, nr=32):
    """(rec (1 | G, nr, 3), lig (G, 3, n_lig)) float32: pose g's ligand
    atoms at squared distance ``d2[g]`` from one receptor atom (row 5, or
    per pose row 7g mod 32), every other receptor atom 1000 A or more
    away."""
    g = d2.shape[0]
    far = np.stack([1000.0 * (np.arange(nr) + 1), np.zeros(nr), np.zeros(nr)], axis=1)
    rows = (7 * np.arange(g)) % nr if per_pose else np.full(g, 5)
    rec = np.repeat(far[None], g if per_pose else 1, axis=0).astype(np.float32)
    rec[np.arange(rec.shape[0]), rows[:rec.shape[0]]] = 0.0
    lig = np.zeros((g, 3, n_lig), dtype=np.float32)
    for i, target in enumerate(d2):
        x, y = _offset_at(target)
        for j in range(n_lig):   # (x, y, 0) with its axes turned: the same d2
            lig[i, (np.arange(3) + j) % 3, j] = (x, y, 0.0)
    return rec, lig


def cutoff_edge_case(device="cpu", per_pose: bool = False, n_lig: int = 4,
                     ulps: int = 1) -> CutoffEdgeCase:
    """Inputs of the elec/vdw pair kernels K3 and K5 (``ops.elec_vdw_pairs``
    and ``ops.elec_vdw_pairs_v1``; 32 x 128 tiles) whose pairs sit on the
    cutoffs: pose g puts its ``n_lig`` ligand atoms at squared distance
    ``d2[g]`` from one receptor atom (as in :func:`bin_edge_case`), d2
    running over the interface (3.9^2), vdw (10^2) and elec (30^2) cutoffs
    as float32 (the value the kernels and the plain versions compare with)
    and ``ulps`` ulps either side of each; every other pair is 1000 A or
    more apart.
    Charges 0.1 on the receptor and 0.1 (1 + (j mod 4) / 4) on ligand atom
    j, vdw energies 1 and radii 2.5, so a pair's term at the elec cutoff is
    at least 9e-4 and at the vdw cutoff about -0.03: a mask one off moves
    its pose's sum far beyond 5e-5, and a flag one off shows in the flags.
    Every cull and interface bit is set; no near bits."""
    d2 = _ulps_around([C.INTERFACE_CUTOFF2, C.VDW_DIST_CUTOFF2, C.ELEC_DIST_CUTOFF2], ulps)
    g, nr = d2.shape[0], 32
    rec, lig = _edge_geometry(d2, per_pose, n_lig, nr)

    def vec(values):
        return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)

    atoms = (vec(np.full(nr, 0.1)), vec(0.1 * (1.0 + 0.25 * (np.arange(n_lig) % 4))),
             vec(np.ones(nr)), vec(np.ones(n_lig)), vec(np.full(nr, 2.5)),
             vec(np.full(n_lig, 2.5)))
    coords = (torch.as_tensor(rec, device=device), torch.as_tensor(lig, device=device))
    n_chunks = -(-g // dp.POSE_BLOCK)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.int32, device=device)

    kwargs = dict(r_tile=32, l_tile=128, need_iface=True)
    return CutoffEdgeCase(
        (coords + atoms + (ones(1, 1, n_chunks), ones(1, 1, g)),
         dict(kwargs, near_chunks=None)),
        (coords + atoms + (ones(1, 1, g), ones(1, 1, g)), kwargs),
        d2)
