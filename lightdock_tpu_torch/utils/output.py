"""gso_N.out snapshots and their full-precision ``.npz`` sidecars.

Port of ``lightdock_tpu/utils/output.py``.  Each snapshot is written by
the port's native writer (``utils.native.write_gso``, ``csrc/io_native.cpp``),
byte-compatible with the reference (src/swarm.rs:128-167): a header line,
then per glowworm the pose tuple at 7 decimals, the literal
``    0    0   `` column pair, luciferin at 8 decimals, neighbour count,
vision range at 3 decimals and scoring at 8 decimals.
``format_gso_output`` renders the same text in Python: it is the writer's
plain version, which the tests and ``chip_smoke.py`` hold it against, and
no run writes through it.  ``read_gso_output`` parses a snapshot back
into arrays (the text resume path).
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

from . import native
from .metrics import span

HEADER = "#Coordinates  RecID  LigID  Luciferin  Neighbor's number  Vision Range  Scoring"


def format_gso_output(poses, luciferin, num_neighbors, vision, scoring) -> str:
    """Render the file body as a string (the native writer's plain
    version)."""
    lines = [HEADER]
    for g in range(poses.shape[0]):
        tup = ", ".join(f"{v:.7f}" for v in poses[g])
        lines.append(
            f"({tup})    0    0   {luciferin[g]:.8f}  "
            f"{int(num_neighbors[g])} {vision[g]:.3f} {scoring[g]:.8f}"
        )
    return "\n".join(lines) + "\n"


def write_gso_output(path, poses, luciferin, num_neighbors, vision, scoring) -> None:
    """Write one snapshot with the native writer (span ``write_text``)."""
    with span("write_text"):
        native.write_gso(path, poses, luciferin, num_neighbors, vision, scoring)


def sidecar_path(out_path) -> pathlib.Path:
    """Full-precision checkpoint sidecar next to a gso_N.out file."""
    p = pathlib.Path(out_path)
    return p.with_suffix(p.suffix + ".npz")


def write_state_sidecar(out_path, step: int, **arrays) -> None:
    """Write the full-precision swarm state next to the text snapshot: the
    text rounds to 7/8 decimals, the sidecar keeps the device's bits, so a
    resumed run is bit-identical (span ``write_sidecar``)."""
    with span("write_sidecar"):
        np.savez(sidecar_path(out_path), step=np.int64(step),
                 **{k: np.asarray(v) for k, v in arrays.items()})


def read_state_sidecar(path):
    """Load a sidecar (the .out path or the .npz path): (step, dict of
    arrays), or None when there is none."""
    p = pathlib.Path(path)
    if p.suffix != ".npz":
        p = sidecar_path(p)
    if not p.exists():
        return None
    with np.load(p) as z:
        data = {k: z[k] for k in z.files if k != "step"}
        return int(z["step"]), data


_LINE_RE = re.compile(r"\(([^)]*)\)\s+0\s+0\s+(\S+)\s+(\d+)\s+(\S+)\s+(\S+)")


def read_gso_output(path):
    """Parse a gso_N.out file back into arrays: (poses (G, D), luciferin
    (G,), num_neighbors (G,), vision (G,), scoring (G,))."""
    poses, luc, nn, vis, sco = [], [], [], [], []
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable gso line: {line!r}")
        poses.append([float(v) for v in m.group(1).split(",")])
        luc.append(float(m.group(2)))
        nn.append(int(m.group(3)))
        vis.append(float(m.group(4)))
        sco.append(float(m.group(5)))
    return (
        np.asarray(poses, dtype=np.float64),
        np.asarray(luc, dtype=np.float64),
        np.asarray(nn, dtype=np.int64),
        np.asarray(vis, dtype=np.float64),
        np.asarray(sco, dtype=np.float64),
    )
