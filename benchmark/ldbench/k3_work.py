"""The least work of the elec/vdw pair kernel K3 and the least time the
H100 needs for it, for its roofline share.

Every atom pair of a scored pose costs at least the elec term alone: 13
operations (``chip_smoke.py``'s count of a far pair; a near pair costs 22).
Each scored pose brings its receptor and ligand coordinates once (3 float32
each: the receptor is a pose's own with receptor ANM), and each call the
atoms' charges, vdw energies and radii (3 float32 an atom).  The bound is
the larger of the operations at the card's float32 peak and the bytes at
its memory bandwidth.
"""

from __future__ import annotations

import pathlib

FLOPS_PAIR = 13          # the elec term of one atom pair
BYTES_ATOM = 3 * 4       # three float32 an atom: a coordinate, or the parameters
PEAK_FLOPS = 67e12       # H100 SXM float32, non-tensor
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def work(poses: int, n_rec: int, n_lig: int, calls: int) -> tuple:
    """(operations, bytes) of ``poses`` scored poses of ``n_rec`` x ``n_lig``
    atoms over ``calls`` energy calls."""
    ops = poses * n_rec * n_lig * FLOPS_PAIR
    nbytes = (poses + calls) * (n_rec + n_lig) * BYTES_ATOM
    return ops, nbytes


def bound_s(ops: int, nbytes: int) -> float:
    """The least seconds for that work on the card."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def atoms(job_dir) -> tuple:
    """(receptor atoms, ligand atoms) of the complex of a run's job: the
    ``ATOM`` lines of ``complex/lightdock_rec.pdb`` and ``lightdock_lig.pdb``
    beside the run's ``jobs`` directory."""
    root = pathlib.Path(job_dir).parents[1] / "complex"

    def count(name):
        lines = (root / f"lightdock_{name}.pdb").read_text().splitlines()
        return sum(line.startswith(("ATOM", "HETATM")) for line in lines)

    return count("rec"), count("lig")
