"""The inputs of a run, made from its seed: a stand-in complex as LightDock's
files, the DFIRE table, and fresh positions for every job.

A frozen copy of the stand-in generator of the program under test
(``write_complex``, ``membrane_system``), in NumPy, so that no change to the
program moves the inputs.  Atoms lie uniform in a cube of ``box`` A; atom
names cycle through residue templates of the DFIRE tables (the 20 amino
acids); the first residue of each side is an active restraint.  Where the
configuration has a ``membrane``, that many of the receptor's atoms are
membrane beads (``MMB`` ``BJ``): a square lattice in the plane z =
``membrane.z``, ring by ring outwards from the protein's footprint, as a
lipid layer around a channel.

The swarms sit where LightDock's setup puts them (``lightdock/prep/poses.py``
``calculate_surface_points``): on the receptor's surface, a quarter of the
ligand's largest diameter out from it.  Here the surface point in a
direction u from the protein's centre is the farthest protein atom within
``SURFACE_PROBE`` A of that ray; the directions are the golden spiral of
LightDock's ``points_on_sphere``, ``CANDIDATES`` a swarm, and the
``swarm_centres`` used are spread evenly over those left.  With a membrane,
a centre closer than the swarm's radius to the beads' plane is left out,
as the setup's ``--membrane`` keeps swarms out of the membrane.  Each job's
swarms start at fresh positions drawn from (seed, job): translations
uniform in a ball of ``swarm_radius`` A around the centre (LightDock's
swarm radius, 10 A) and unit quaternions from normal draws.  Swarm s of
job j sits at centre (j * swarms + s) mod the centres, so a job of one
swarm walks the centres in turn and every seed does the same work.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

TABLES = json.loads((pathlib.Path(__file__).resolve().parents[1] / "reference"
                     / "dfire_tables.json").read_text())
AMINO_ACIDS = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
               "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
N_TABLE = 169 * 169 * 20

# Streams of one seed, one for each thing drawn.
ATOMS, TABLE, POSITIONS, CHECK = range(4)
SURFACE_PROBE = 4.0   # A from a ray in which an atom counts as on it
CANDIDATES = 4        # spiral directions a swarm


def stream(seed: int, *keys: int) -> np.random.Generator:
    """The generator for ``keys`` under ``seed`` (any integer)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, *keys]))


def templates():
    """(residue, its DFIRE atom names) of the 20 amino acids."""
    keys = [(k[:3], k[3:]) for k in TABLES["atom_slot"]]
    return [(res, [a for r, a in keys if r == res]) for res in AMINO_ACIDS]


def pdb_lines(xyz, chain, bead=None):
    """(ATOM records of ``xyz`` (N, 3), the id of the first amino acid):
    residue k takes template k mod 20, or is an ``MMB`` residue of one
    ``BJ`` atom where ``bead`` is set."""
    tpl = templates()
    bead = np.zeros(len(xyz), dtype=bool) if bead is None else bead
    lines, res, k, left, first = [], None, 0, [], None
    for i, (x, y, z) in enumerate(xyz):
        if bead[i]:
            k += 1
            res, name, left = "MMB", "BJ", []
        else:
            if not left:
                res, names = tpl[k % len(tpl)]
                k += 1
                left = list(names)
                first = first or f"{chain}.{res}.{k}"
            name = left.pop(0)
        field = name if len(name) == 4 else f" {name:<3}"
        lines.append(f"ATOM  {i + 1:5d} {field} {res:>3} {chain}{k:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00")
    return lines, first


def spiral(n: int) -> np.ndarray:
    """(n, 3) unit vectors on the golden spiral (LightDock's
    ``points_on_sphere``), from the pole z = 1 down."""
    k = np.arange(n) + 0.5
    z = 1.0 - 2.0 * k / n
    r = np.sqrt(1.0 - z * z)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * k
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def max_diameter(xyz: np.ndarray) -> float:
    """The largest distance between two of the atoms ``xyz`` (N, 3)."""
    best = 0.0
    for i in range(0, len(xyz), 512):
        d = ((xyz[i:i + 512, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        best = max(best, float(d.max()))
    return float(np.sqrt(best))


def bead_plane(n: int, half: float, spacing: float, z: float) -> np.ndarray:
    """(n, 3) lattice points of ``spacing`` in the plane ``z``, outside the
    square of half-width ``half``, nearest rings first (then by angle)."""
    m = int(np.ceil(half / spacing)) + int(np.ceil(np.sqrt(n) / 2)) + 2
    i, j = np.meshgrid(np.arange(-m, m + 1), np.arange(-m, m + 1), indexing="ij")
    xy = np.stack([i.ravel(), j.ravel()], axis=1) * spacing
    ring = np.abs(xy).max(axis=1)
    keep = ring > half
    xy, ring = xy[keep], ring[keep]
    order = np.lexsort((np.arctan2(xy[:, 1], xy[:, 0]), ring))[:n]
    return np.concatenate([xy[order], np.full((n, 1), z)], axis=1)


def swarm_centres(protein: np.ndarray, ligand: np.ndarray, n: int, swarm_radius: float,
                  membrane_z=None) -> np.ndarray:
    """(n, 3) swarm centres on the surface of ``protein`` (see the module's
    docstring)."""
    c = protein.mean(axis=0)
    x = protein - c
    out, out_by = [], max_diameter(ligand) / 4.0
    for u in spiral(CANDIDATES * n):
        along = x @ u
        near = (along > 0) & (((x - along[:, None] * u) ** 2).sum(-1) < SURFACE_PROBE ** 2)
        if near.any():
            out.append(c + (along[near].max() + out_by) * u)
    out = np.array(out)
    if membrane_z is not None:
        out = out[np.abs(out[:, 2] - membrane_z) >= swarm_radius]
    if len(out) < n:
        raise ValueError(f"{len(out)} surface points for {n} swarms")
    return out[np.round(np.linspace(0, len(out) - 1, n)).astype(int)]


class Complex:
    """The files of one run's complex under ``root``: ``lightdock_rec.pdb``,
    ``lightdock_lig.pdb``, ``setup.json`` and ``data/DCparams``."""

    def __init__(self, config: dict, seed: int, root):
        self.config, self.seed = config, seed
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        rng = stream(seed, ATOMS)
        half = config["box"] / 2.0
        membrane = config.get("membrane")
        self.n_beads = membrane["beads"] if membrane else 0
        protein = rng.uniform(-half, half, size=(config["receptor_atoms"] - self.n_beads, 3))
        lig = rng.uniform(-half, half, size=(config["ligand_atoms"], 3))
        rec = protein
        if membrane:
            rec = np.concatenate([protein, bead_plane(self.n_beads, half, membrane["spacing"],
                                                      membrane["z"])])
        # The coordinates as the PDB files hold them.
        self.rec = np.round(rec, 3)
        self.lig = np.round(lig, 3)
        bead = np.arange(len(self.rec)) >= len(protein)
        restraints = {}
        for side, name, xyz, chain, beads in (("receptor", "rec", self.rec, "A", bead),
                                              ("ligand", "lig", self.lig, "B", None)):
            lines, first = pdb_lines(xyz, chain, beads)
            (self.root / f"lightdock_{name}.pdb").write_text("\n".join(lines + ["END"]) + "\n")
            restraints[side] = {"active": [first], "passive": [], "blocked": []}
        self.setup_seed = int(stream(seed, ATOMS, 1).integers(1, 2 ** 31))
        setup = {"receptor_pdb": "rec.pdb", "ligand_pdb": "lig.pdb",
                 "seed": self.setup_seed, "use_anm": False, "anm_rec": 0, "anm_lig": 0,
                 "glowworms": config["glowworms"],
                 "receptor_restraints": restraints["receptor"],
                 "ligand_restraints": restraints["ligand"]}
        self.setup = self.root / "setup.json"
        self.setup.write_text(json.dumps(setup, indent=2))
        self.data = self.root / "data"
        self.data.mkdir(exist_ok=True)
        # Smooth in distance, as DFIRE's potentials are: a random walk over
        # the 20 bins of each type pair.
        rng = stream(seed, TABLE)
        rows = rng.normal(0.0, config["table_sd"], (N_TABLE // 20, 1)) + np.cumsum(
            rng.normal(0.0, config["table_step_sd"], (N_TABLE // 20, 20)), axis=1)
        table = rows.reshape(-1)
        (self.data / "DCparams").write_text("\n".join(f"{v:.6f}" for v in table) + "\n")
        self.centres = swarm_centres(self.rec[~bead], self.lig, config["swarm_centres"],
                                     config["swarm_radius"],
                                     membrane["z"] if membrane else None)

    def positions(self, job: int, swarms: int) -> list:
        """The (G, 7) starting poses of each of ``swarms`` swarms of ``job``."""
        rng = stream(self.seed, POSITIONS, job)
        g, radius = self.config["glowworms"], self.config["swarm_radius"]
        out = []
        for s in range(swarms):
            centre = self.centres[(job * swarms + s) % len(self.centres)]
            d = rng.standard_normal((g, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            t = centre + d * radius * rng.uniform(0, 1, (g, 1)) ** (1 / 3)
            q = rng.standard_normal((g, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            out.append(np.concatenate([t, q], axis=1))
        return out

    def write_job(self, job: int, swarms: int, directory) -> list:
        """Write ``initial_positions_<s>.dat`` of ``job`` under
        ``directory``/init; returns their paths."""
        init = pathlib.Path(directory) / "init"
        init.mkdir(parents=True, exist_ok=True)
        paths = []
        for s, poses in enumerate(self.positions(job, swarms)):
            path = init / f"initial_positions_{s}.dat"
            path.write_text("".join(" ".join(repr(float(v)) for v in row) + "\n"
                                    for row in poses))
            paths.append(path)
        return paths
