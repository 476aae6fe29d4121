"""ctypes bindings to the port's host IO library, ``csrc/io_native.cpp``:
the PDB reader and the ``gso_N.out`` writer.

Port of ``lightdock_tpu/utils/native.py``.  The library is built with the
host C++ compiler at first use (``ops/_build.py``, keyed by the source's
hash, into ``lightdock_tpu_torch/build/``).  Unlike the JAX package's
bindings, a failed build raises with the compiler's log and nothing turns
the library off: the Python versions (``utils.pdb.parse_pdb_plain``,
``utils.output.format_gso_output``) are its plain versions, for the tests
and ``chip_smoke.py``, and not a fallback.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..ops import _build

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def _lib() -> ctypes.CDLL:
    """The built library with its functions' types declared (a dictionary
    lookup once it is loaded, and a few attribute stores)."""
    lib = _build.load("io_native").lib
    lib.ld_parse_pdb.restype = ctypes.c_void_p
    lib.ld_parse_pdb.argtypes = [ctypes.c_char_p]
    lib.ld_pdb_natoms.restype = ctypes.c_int64
    lib.ld_pdb_natoms.argtypes = [ctypes.c_void_p]
    lib.ld_pdb_bad_line.restype = ctypes.c_int64
    lib.ld_pdb_bad_line.argtypes = [ctypes.c_void_p]
    lib.ld_pdb_coords.restype = _DOUBLE_P
    lib.ld_pdb_coords.argtypes = [ctypes.c_void_p]
    lib.ld_pdb_strings.restype = ctypes.c_char_p
    lib.ld_pdb_strings.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ld_pdb_free.restype = None
    lib.ld_pdb_free.argtypes = [ctypes.c_void_p]
    lib.ld_write_gso.restype = ctypes.c_int
    lib.ld_write_gso.argtypes = [
        ctypes.c_char_p,                                # path
        _DOUBLE_P, ctypes.c_int64, ctypes.c_int64,      # poses (G, pose_dim)
        _DOUBLE_P,                                      # luciferin
        ctypes.POINTER(ctypes.c_int64),                 # num_neighbors
        _DOUBLE_P,                                      # vision
        _DOUBLE_P,                                      # scoring
    ]
    return lib


def parse_pdb(path):
    """(atom_names, res_names, res_ids, chain_ids, coords (N, 3) float64)
    of the ATOM/HETATM records of a PDB file; a record whose coordinates
    Python's float() would refuse raises ValueError, as in
    ``utils.pdb.parse_pdb_plain``."""
    lib = _lib()
    handle = lib.ld_parse_pdb(os.fsencode(path))
    if not handle:
        raise FileNotFoundError(f"cannot open PDB file {str(path)!r}")
    try:
        bad_line = lib.ld_pdb_bad_line(handle)
        n = lib.ld_pdb_natoms(handle)
        coords = (np.ctypeslib.as_array(lib.ld_pdb_coords(handle), shape=(n, 3)).copy()
                  if n else np.zeros((0, 3)))
        columns = [lib.ld_pdb_strings(handle, which).decode().split("\x1f") if n else []
                   for which in range(4)]  # atom_names, res_names, res_ids, chain_ids
    finally:
        lib.ld_pdb_free(handle)
    if bad_line:
        raise ValueError(f"{str(path)!r} line {bad_line}: unreadable coordinates")
    if any(len(c) != n for c in columns):
        raise ValueError(f"{str(path)!r}: a name column holds the separator \\x1f")
    return (*columns, coords)


def write_gso(path, poses, luciferin, num_neighbors, vision, scoring) -> None:
    """Write one ``gso_N.out`` snapshot; raises OSError when it cannot."""
    lib = _lib()
    poses = np.ascontiguousarray(poses, dtype=np.float64)
    g, pose_dim = poses.shape
    cols = [np.ascontiguousarray(a, dtype=np.float64) for a in (luciferin, vision, scoring)]
    nn = np.ascontiguousarray(num_neighbors, dtype=np.int64)
    if any(a.shape != (g,) for a in (*cols, nn)):
        raise ValueError(f"snapshot columns of shapes {[a.shape for a in (*cols, nn)]} "
                         f"for {g} poses")
    luc, vis, sco = cols
    rc = lib.ld_write_gso(
        os.fsencode(path), poses.ctypes.data_as(_DOUBLE_P), g, pose_dim,
        luc.ctypes.data_as(_DOUBLE_P), nn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vis.ctypes.data_as(_DOUBLE_P), sco.ctypes.data_as(_DOUBLE_P))
    if rc != 0:
        raise OSError(rc, os.strerror(rc), str(path))
