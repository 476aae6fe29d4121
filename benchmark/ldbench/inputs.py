"""The inputs of a run, made from its seed: a stand-in complex as LightDock's
files, the DFIRE table, the ANM modes, and fresh positions for every job.

A frozen copy of the stand-in generator of the program under test
(``write_complex``, ``membrane_system``), in NumPy, so that no change to the
program moves the inputs.  Atoms lie uniform in a cube of ``box`` A; atom
names cycle through residue templates of the tables of the configuration's
``method`` (``ldbench.methods``): for ``dfire`` the 20 amino acids on both sides (DFIRE's
``atom_slot`` names), for ``dna`` the amino acids on the receptor and the
nucleotides DA, DC, DG, DT on the ligand (the AMBER ``amber_types`` names
of ``reference/dna_tables.json``); the first residue of each side is an
active restraint.  Only ``dfire`` writes a table (``data/DCparams``).  Where the
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

Where the configuration has ``anm_rec`` or ``anm_lig`` modes, they are
written as ``rec_nm.npy`` and ``lig_nm.npy`` (K, N, 3) beside the PDB files
and ``setup.json`` says so (``use_anm``, ``anm_rec``, ``anm_lig``).  They
are built as ANM's low modes are: smooth in space, free of the rigid
motions, orthonormal over the 3N coordinates.  Each of a side's K modes
starts as a field of ``MODE_WAVES`` plane waves a coordinate, of normal
amplitudes and random phases, whose wave vectors have random directions
and at most one period across the side's extent; the six rigid motions
(three translations, three rotations about the centre) are projected out
and the K fields made orthonormal (a QR factorisation), so each has unit
norm.  Each row of a positions file then has ``anm_rec + anm_lig``
coefficients after its pose, standard normal as LightDock's setup draws
them, from a stream of their own: the translations and rotations are
those of a rigid configuration of the same seed.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from .methods import method as method_of

N_TABLE = 169 * 169 * 20

# Streams of one seed, one for each thing drawn.
ATOMS, TABLE, POSITIONS, CHECK, MODES, COEFFICIENTS = range(6)
SURFACE_PROBE = 4.0   # A from a ray in which an atom counts as on it
CANDIDATES = 4        # spiral directions a swarm
MODE_WAVES = 3        # plane waves a coordinate of a mode's field


def stream(seed: int, *keys: int) -> np.random.Generator:
    """The generator for ``keys`` under ``seed`` (any integer)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, *keys]))


def templates(atoms: list, residues) -> list:
    """(residue, its atom names) of each of ``residues``, from ``atoms``, the
    (residue, atom name) keys of a method's tables."""
    return [(res, [a for r, a in atoms if r == res]) for res in residues]


def pdb_lines(xyz, chain, tpl, bead=None):
    """(ATOM records of ``xyz`` (N, 3), the id of the first residue that is
    no bead): residue k takes template k mod the count of ``tpl``, or is an
    ``MMB`` residue of one ``BJ`` atom where ``bead`` is set."""
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


def smooth_modes(rng: np.random.Generator, xyz: np.ndarray, k: int) -> np.ndarray:
    """(k, N, 3) modes of the atoms ``xyz`` (N, 3), smooth, free of the rigid
    motions and orthonormal over the 3N coordinates (see the module's
    docstring)."""
    n = len(xyz)
    x = xyz - xyz.mean(axis=0)
    extent = float(np.ptp(xyz, axis=0).max())
    amp = rng.standard_normal((k, 3, MODE_WAVES))
    phase = rng.uniform(0.0, 2 * np.pi, (k, 3, MODE_WAVES))
    direction = rng.standard_normal((k, 3, MODE_WAVES, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    wave = direction * (rng.uniform(0.0, 1.0, (k, 3, MODE_WAVES, 1)) / extent)
    # fields[m, c, i] = sum_w amp cos(2 pi wave . x_i + phase)
    fields = (amp[..., None] * np.cos(2 * np.pi * np.einsum("mcwd,nd->mcwn", wave, x)
                                      + phase[..., None])).sum(axis=2)
    fields = fields.transpose(0, 2, 1).reshape(k, 3 * n)
    rigid = np.zeros((6, n, 3))
    for c in range(3):
        rigid[c, :, c] = 1.0
        rigid[3 + c] = np.cross(np.eye(3)[c], x)
    basis, _ = np.linalg.qr(rigid.reshape(6, 3 * n).T)
    fields -= (fields @ basis) @ basis.T
    modes, _ = np.linalg.qr(fields.T)
    return modes.T.reshape(k, n, 3)


class Complex:
    """The files of one run's complex under ``root``: ``lightdock_rec.pdb``,
    ``lightdock_lig.pdb``, ``setup.json``, for ``dfire`` ``data/DCparams``,
    and with ANM modes ``rec_nm.npy`` and ``lig_nm.npy``."""

    def __init__(self, config: dict, seed: int, root):
        self.config, self.seed = config, seed
        method = config["method"]
        entry = method_of(method)
        self.anm = (config.get("anm_rec", 0), config.get("anm_lig", 0))
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
        atoms = entry.atoms()
        for side, name, xyz, chain, residues, beads in (
                ("receptor", "rec", self.rec, "A", entry.receptor, bead),
                ("ligand", "lig", self.lig, "B", entry.ligand, None)):
            lines, first = pdb_lines(xyz, chain, templates(atoms, residues), beads)
            (self.root / f"lightdock_{name}.pdb").write_text("\n".join(lines + ["END"]) + "\n")
            restraints[side] = {"active": [first], "passive": [], "blocked": []}
        self.setup_seed = int(stream(seed, ATOMS, 1).integers(1, 2 ** 31))
        setup = {"receptor_pdb": "rec.pdb", "ligand_pdb": "lig.pdb",
                 "seed": self.setup_seed, "use_anm": sum(self.anm) > 0,
                 "anm_rec": self.anm[0], "anm_lig": self.anm[1],
                 "glowworms": config["glowworms"],
                 "receptor_restraints": restraints["receptor"],
                 "ligand_restraints": restraints["ligand"]}
        self.setup = self.root / "setup.json"
        self.setup.write_text(json.dumps(setup, indent=2))
        self.data = self.root / "data"
        if method == "dfire":
            self.data.mkdir(exist_ok=True)
            # Smooth in distance, as DFIRE's potentials are: a random walk
            # over the 20 bins of each type pair.
            rng = stream(seed, TABLE)
            rows = rng.normal(0.0, config["table_sd"], (N_TABLE // 20, 1)) + np.cumsum(
                rng.normal(0.0, config["table_step_sd"], (N_TABLE // 20, 20)), axis=1)
            table = rows.reshape(-1)
            (self.data / "DCparams").write_text("\n".join(f"{v:.6f}" for v in table) + "\n")
        for k, name, xyz, key in ((self.anm[0], "rec", self.rec, 0),
                                  (self.anm[1], "lig", self.lig, 1)):
            if k:
                np.save(self.root / f"{name}_nm.npy", smooth_modes(stream(seed, MODES, key),
                                                                    xyz, k))
        self.centres = swarm_centres(self.rec[~bead], self.lig, config["swarm_centres"],
                                     config["swarm_radius"],
                                     membrane["z"] if membrane else None)

    def positions(self, job: int, swarms: int) -> list:
        """The (G, 7 + anm_rec + anm_lig) starting poses of each of
        ``swarms`` swarms of ``job``."""
        rng = stream(self.seed, POSITIONS, job)
        coefficients = stream(self.seed, COEFFICIENTS, job)
        g, radius = self.config["glowworms"], self.config["swarm_radius"]
        out = []
        for s in range(swarms):
            centre = self.centres[(job * swarms + s) % len(self.centres)]
            d = rng.standard_normal((g, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            t = centre + d * radius * rng.uniform(0, 1, (g, 1)) ** (1 / 3)
            q = rng.standard_normal((g, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            anm = coefficients.standard_normal((g, sum(self.anm)))
            out.append(np.concatenate([t, q, anm], axis=1))
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
