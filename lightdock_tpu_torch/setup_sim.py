"""Simulation setup: swarm centres, initial poses, setup.json.

Port of ``lightdock_tpu/setup_sim.py`` (NumPy host code; nothing here is
worth a device), behind ``lightdock-tpu-torch-tools setup``.  From a
receptor and a ligand PDB file it writes what the command line reads:
the ``lightdock_``-prefixed working copies (hydrogen, OXT and water
filters), swarm centres over the receptor surface beyond the ligand's
reach, each swarm's glowworm poses (translations in the swarm sphere,
Shoemake-uniform quaternions, Box-Muller ANM coefficients) drawn from the
bit-exact rand-0.7 stream (``utils.rng.ReferenceRng``) in the JAX
package's order, and ``setup.json`` with ``init/initial_positions_N.dat``.
Its files equal the JAX package's byte for byte.

The poses are deterministic in ``starting_points_seed`` but are not
lightdock3's sampler (another algorithm); the files are drop-in *format*
compatible with ``lightdock3_setup.py``'s (reference
example/1czy/execution.sh:7).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import numpy as np

from .constants import DEFAULT_LIGHTDOCK_PREFIX, DEFAULT_SEED
from .utils.pdb import parse_pdb
from .utils.rng import ReferenceRng

DEFAULT_SWARM_RADIUS = 10.0
DEFAULT_SURFACE_CLEARANCE = 5.0


@dataclasses.dataclass
class SetupConfig:
    receptor_pdb: str
    ligand_pdb: str
    swarms: int = 10
    glowworms: int = 200
    use_anm: bool = False
    anm_rec: int = 10
    anm_lig: int = 10
    seed: int = DEFAULT_SEED
    starting_points_seed: int = DEFAULT_SEED
    anm_seed: int = DEFAULT_SEED
    swarm_radius: float = DEFAULT_SWARM_RADIUS
    noh: bool = False
    noxt: bool = True
    now: bool = True


def _keep_atom(line: str, noh: bool, noxt: bool, now: bool) -> bool:
    name = line[12:16].strip()
    res = line[17:20].strip()
    if noxt and name == "OXT":
        return False
    if now and res == "HOH":
        return False
    if noh:
        element = line[76:78].strip() if len(line) >= 78 else ""
        if element == "H" or (not element and name[:1] == "H") \
                or (not element and name[:1].isdigit() and "H" in name[:3]):
            return False
    return True


def prepare_structure(src, dst, noh: bool, noxt: bool, now: bool) -> int:
    """Write the ``lightdock_``-prefixed working copy with the atom filters
    applied (the analogue of lightdock3's parser step); returns the atoms
    kept."""
    kept = 0
    with open(dst, "w") as out:
        for line in pathlib.Path(src).read_text().splitlines():
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                if not _keep_atom(line, noh, noxt, now):
                    continue
                kept += 1
            elif rec.strip() not in ("TER", "END", "ENDMDL", "MODEL"):
                continue
            out.write(line + "\n")
    return kept


def fibonacci_directions(n: int) -> np.ndarray:
    """n approximately uniform unit vectors (Fibonacci sphere)."""
    i = np.arange(n, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    theta = phi * i
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


def swarm_centers(rec_coords: np.ndarray, lig_coords: np.ndarray,
                  num_swarms: int,
                  clearance: float = DEFAULT_SURFACE_CLEARANCE) -> np.ndarray:
    """Swarm centres over the receptor surface, pushed out far enough that
    a ligand centred there cannot clash with the receptor."""
    center = rec_coords.mean(axis=0)
    lig_radius = np.linalg.norm(
        lig_coords - lig_coords.mean(axis=0), axis=1).max()
    dirs = fibonacci_directions(num_swarms)
    rel = rec_coords - center
    extent = (rel @ dirs.T).max(axis=0)        # farthest extent along each direction
    dist = extent + lig_radius + clearance
    return center[None, :] + dirs * dist[:, None]


def sample_glowworms(rng: ReferenceRng, center: np.ndarray, cfg: SetupConfig
                     ) -> np.ndarray:
    """(G, D) initial pose rows: a translation in the swarm sphere, a
    Shoemake-uniform quaternion, N(0, 1) ANM coefficients."""
    rows = []
    for _ in range(cfg.glowworms):
        # rejection-sample a point in the unit ball (exact-stream draws)
        while True:
            u = rng.gen(3) * 2.0 - 1.0
            if float(u @ u) <= 1.0:
                break
        t = center + u * cfg.swarm_radius
        u1, u2, u3 = rng.gen(3)
        q = (math.sqrt(1 - u1) * math.sin(2 * math.pi * u2),
             math.sqrt(1 - u1) * math.cos(2 * math.pi * u2),
             math.sqrt(u1) * math.sin(2 * math.pi * u3),
             math.sqrt(u1) * math.cos(2 * math.pi * u3))
        row = list(t) + list(q)
        if cfg.use_anm:
            # Box-Muller over the exact stream, a spread comparable to the
            # reference examples' ANM coefficients.
            n_coef = cfg.anm_rec + cfg.anm_lig
            coefs = []
            while len(coefs) < n_coef:
                a, b = rng.gen(2)
                r = math.sqrt(-2.0 * math.log(max(a, 1e-300)))
                coefs.append(r * math.cos(2 * math.pi * b))
                coefs.append(r * math.sin(2 * math.pi * b))
            row += coefs[:n_coef]
        rows.append(row)
    return np.asarray(rows, dtype=np.float64)


def write_positions(path, rows: np.ndarray) -> None:
    with open(path, "w") as fh:
        for row in rows:
            fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")


def run_setup(cfg: SetupConfig, workdir=".") -> dict:
    """Write the whole input set of a run under ``workdir``; returns the
    setup dict (also written to setup.json)."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    rec_name = pathlib.Path(cfg.receptor_pdb).name
    lig_name = pathlib.Path(cfg.ligand_pdb).name
    rec_path = workdir / f"{DEFAULT_LIGHTDOCK_PREFIX}{rec_name}"
    lig_path = workdir / f"{DEFAULT_LIGHTDOCK_PREFIX}{lig_name}"
    prepare_structure(cfg.receptor_pdb, rec_path, cfg.noh, cfg.noxt, cfg.now)
    prepare_structure(cfg.ligand_pdb, lig_path, cfg.noh, cfg.noxt, cfg.now)

    centers = swarm_centers(parse_pdb(rec_path).coordinates,
                            parse_pdb(lig_path).coordinates, cfg.swarms)
    rng = ReferenceRng(cfg.starting_points_seed)
    init_dir = workdir / "init"
    init_dir.mkdir(exist_ok=True)
    for s in range(cfg.swarms):
        write_positions(init_dir / f"initial_positions_{s}.dat",
                        sample_glowworms(rng, centers[s], cfg))

    setup = {
        "seed": cfg.seed,
        "anm_seed": cfg.anm_seed,
        "ftdock_file": None,
        "noh": cfg.noh,
        "anm_rec": cfg.anm_rec,
        "anm_lig": cfg.anm_lig,
        "swarms": cfg.swarms,
        "starting_points_seed": cfg.starting_points_seed,
        "verbose_parser": False,
        "noxt": cfg.noxt,
        "now": cfg.now,
        "restraints": None,
        "use_anm": cfg.use_anm,
        "glowworms": cfg.glowworms,
        "membrane": False,
        "receptor_pdb": rec_name,
        "ligand_pdb": lig_name,
        "receptor_restraints": None,
        "ligand_restraints": None,
        "swarm_radius": cfg.swarm_radius,
    }
    (workdir / "setup.json").write_text(json.dumps(setup, indent=4))
    return setup
