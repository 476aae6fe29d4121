"""Scoring parameters: the host-side record, its builder, and its tensors.

``BatchScoringParams``, ``build_batch_params``, ``dfire_step_tables``,
``dfire_type_tables``, ``dfire_bin_thresholds``, ``ensure_dfire_types``
and ``_res_onehot`` are copies of ``lightdock_tpu/engine/energy_batch.py``,
held equal to their originals by ``tests/test_torch_host.py``.  The
builder differs in one point: ``dfire_mode='auto'`` picks 'types' at
float32 where the original picks 'steps', so the (K, Nr, Nl) ``dfire_dq``
tensor of the step form (0.94 GB at 1k4c) is built only when a caller asks
for 'steps' (the v1 kernel K4 and the dense step form read it; the v2
kernels read the type-indexed tables).

:func:`torch_params` ports ``lightdock_tpu/engine/gso_jax.py``
``device_params``: floating arrays to the run dtype, integer arrays to
int64 (torch's index type).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..scoring import potentials, tables
from ..scoring.models import DockingModel

DFIRE_TYPE_PAD = 176  # 169 atom types padded to a multiple of 8


@dataclasses.dataclass
class BatchScoringParams:
    """Arrays for one receptor/ligand pair and method, built once on the
    host (NumPy); :func:`torch_params` moves them to a device."""

    method: str
    use_anm: bool
    # Receptor
    rec_coords: np.ndarray          # (Nr, 3)
    rec_nmodes: np.ndarray          # (Ka_r, Nr, 3)
    rec_res_onehot: np.ndarray      # (Rr, Nr) 0/1 — active restraint residues
    rec_membrane_mask: np.ndarray   # (Nr,) 0/1
    rec_num_membrane: int
    # Ligand
    lig_coords: np.ndarray          # (Nl, 3)
    lig_nmodes: np.ndarray          # (Ka_l, Nl, 3)
    lig_res_onehot: np.ndarray      # (Rl, Nl)
    # DFIRE
    atom_types_rec: Optional[np.ndarray] = None  # (Nr,) i32
    atom_types_lig: Optional[np.ndarray] = None  # (Nl,) i32
    potential: Optional[np.ndarray] = None       # (571220,)
    dist_to_bins: Optional[np.ndarray] = None    # (51,) i32
    # DNA / PYDOCK
    ele_rec: Optional[np.ndarray] = None
    ele_lig: Optional[np.ndarray] = None
    vdw_c_rec: Optional[np.ndarray] = None
    vdw_c_lig: Optional[np.ndarray] = None
    vdw_r_rec: Optional[np.ndarray] = None
    vdw_r_lig: Optional[np.ndarray] = None
    # DFIRE step form (K, Nr, Nl), built only for dfire_mode='steps'
    dfire_dq: Optional[np.ndarray] = None
    dfire_thresholds: Optional[np.ndarray] = None  # (K,) squared-distance steps
    # DFIRE type-indexed tables (O(Nr + Nl) memory; see dfire_type_tables)
    dfire_rec_half: Optional[np.ndarray] = None    # (K, Nr, DFIRE_TYPE_PAD)
    dfire_lig_onehot: Optional[np.ndarray] = None  # (DFIRE_TYPE_PAD, Nl)


_STATIC_FIELDS = ("method", "use_anm", "rec_num_membrane")
_ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(BatchScoringParams)
                      if f.name not in _STATIC_FIELDS)


def from_reference(p) -> BatchScoringParams:
    """The port's :class:`BatchScoringParams` from any object with the same
    fields, array fields as NumPy arrays or None: the JAX package's
    ``BatchScoringParams`` among them, read by attribute only."""
    kw = {name: getattr(p, name) for name in _STATIC_FIELDS}
    kw.update({name: (None if getattr(p, name) is None
                      else np.asarray(getattr(p, name)))
               for name in _ARRAY_FIELDS})
    kw["rec_num_membrane"] = int(kw["rec_num_membrane"])
    return BatchScoringParams(**kw)


def dfire_bin_thresholds(dist_to_bins, num_bins: int = 32) -> np.ndarray:
    """Squared-distance thresholds s_k at which the DFIRE bin value first
    reaches k; s_0 = 0 (the baseline bin), unreachable bins +inf."""
    bins_of_slot = np.asarray(dist_to_bins, dtype=np.int64) - 1  # value at trunc(d)=m
    thresholds = np.zeros(num_bins, dtype=np.float64)
    for k in range(1, num_bins):
        slots = np.nonzero(bins_of_slot >= k)[0]
        if slots.size == 0:
            thresholds[k] = np.inf  # unreachable bin: step never fires
        else:
            m = slots[0]
            thresholds[k] = ((m + 1) / 2.0) ** 2
    return thresholds


def dfire_step_tables(receptor_types: np.ndarray, ligand_types: np.ndarray,
                      pot_flat: np.ndarray, dist_to_bins: np.ndarray,
                      dtype=np.float32):
    """Gather-free DFIRE step form: the per-pair value is
    ``dq[0, i, j] + sum_k dq[k, i, j] * [d2 >= s_k]``, where ``dq[k]`` is
    the forward difference over bins of the per-type-pair potential and
    ``s_k`` the squared distance at which the bin first reaches k.  Channels
    whose threshold is beyond the 15 A cutoff never fire and are dropped
    (21 of 32 stay with the reference bins).  Returns (dq (K, Nr, Nl),
    thresholds (K,)); thresholds[0] is 0 (bin 0 is the baseline)."""
    num_bins = 32
    p32 = potentials.potential_by_bins(pot_flat, num_bins)   # (169, 169, 32)
    thresholds = dfire_bin_thresholds(dist_to_bins, num_bins)
    live = np.nonzero(thresholds <= C.DFIRE_DIST_CUTOFF2)[0]
    rt = receptor_types.astype(np.int64)
    lt = ligand_types.astype(np.int64)
    dq = np.empty((live.size, rt.size, lt.size), dtype=dtype)
    for out_i, k in enumerate(live):
        tbl = p32[:, :, k] - (p32[:, :, k - 1] if k > 0 else 0.0)
        dq[out_i] = tbl.astype(dtype)[rt[:, None], lt[None, :]]
    return dq, thresholds[live].astype(dtype)


def dfire_type_tables(receptor_types: np.ndarray, ligand_types: np.ndarray,
                      pot_flat: np.ndarray, dist_to_bins: np.ndarray,
                      dtype=np.float32):
    """Type-indexed DFIRE step tables: O(Nr + Nl) memory.

    The per-pair delta potential of live channel k is a function of the two
    atom types, ``dT_k[ta, tb]``, so it factors as
    ``dq[k, i, j] = rec_half[k, i, :] @ onehot(tb_j)`` with
    ``rec_half[k, i, tb] = dT_k[ta_i, tb]``.  Channels whose threshold is
    beyond the 15 A cutoff are dropped.  Returns (rec_half (K, Nr,
    DFIRE_TYPE_PAD), lig_onehot (DFIRE_TYPE_PAD, Nl), thresholds (K,)).
    """
    num_bins = 32
    p32 = potentials.potential_by_bins(pot_flat, num_bins)   # (169, 169, 32)
    thresholds = dfire_bin_thresholds(dist_to_bins, num_bins)
    live = np.nonzero(thresholds <= C.DFIRE_DIST_CUTOFF2)[0]
    rt = receptor_types.astype(np.int64)
    lt = ligand_types.astype(np.int64)
    n_types = p32.shape[0]
    rec_half = np.zeros((live.size, rt.size, DFIRE_TYPE_PAD), dtype=dtype)
    for out_i, k in enumerate(live):
        tbl = p32[:, :, k] - (p32[:, :, k - 1] if k > 0 else 0.0)
        rec_half[out_i, :, :n_types] = tbl.astype(dtype)[rt]
    lig_onehot = np.zeros((DFIRE_TYPE_PAD, lt.size), dtype=dtype)
    lig_onehot[lt, np.arange(lt.size)] = 1.0
    return rec_half, lig_onehot, thresholds[live].astype(dtype)


def ensure_dfire_types(p: BatchScoringParams,
                       dtype=np.float64) -> BatchScoringParams:
    """``p`` with the type-indexed DFIRE tables populated (no-op for other
    methods or when present).  Built at f64: the upload to the device casts
    to the run dtype."""
    if p.method != "dfire" or p.dfire_rec_half is not None:
        return p
    rec_half, lig_onehot, thresholds = dfire_type_tables(
        np.asarray(p.atom_types_rec), np.asarray(p.atom_types_lig),
        np.asarray(p.potential, np.float64), np.asarray(p.dist_to_bins),
        dtype=dtype)
    return dataclasses.replace(p, dfire_rec_half=rec_half,
                               dfire_lig_onehot=lig_onehot,
                               dfire_thresholds=thresholds)


def ensure_dfire_steps(p: BatchScoringParams) -> BatchScoringParams:
    """``p`` with the (K, Nr, Nl) DFIRE step tables populated (no-op for
    other methods or when present), at the dtype ``p`` was built at, as
    ``build_batch_params(dfire_mode='steps')`` builds them."""
    if p.method != "dfire" or p.dfire_dq is not None:
        return p
    dq, thresholds = dfire_step_tables(
        np.asarray(p.atom_types_rec), np.asarray(p.atom_types_lig),
        np.asarray(p.potential, np.float64), np.asarray(p.dist_to_bins),
        dtype=np.asarray(p.rec_coords).dtype)
    return dataclasses.replace(p, dfire_dq=dq, dfire_thresholds=thresholds)


def _res_onehot(model: DockingModel) -> np.ndarray:
    res_of_atom, n_res = model.restraint_segments()
    onehot = np.zeros((n_res, model.num_atoms), dtype=np.float64)
    hit = res_of_atom >= 0
    onehot[res_of_atom[hit], np.nonzero(hit)[0]] = 1.0
    return onehot


def build_batch_params(receptor: DockingModel, ligand: DockingModel,
                       use_anm: bool, dtype=np.float64,
                       potential: Optional[np.ndarray] = None,
                       dfire_mode: str = "auto") -> BatchScoringParams:
    """Build the scoring params of a receptor/ligand pair.

    dfire_mode: 'gather' keeps the reference's flat-table gather (the dense
    oracle), 'steps' also builds the (K, Nr, Nl) step tables of the v1
    kernel path (:func:`dfire_step_tables`, at ``dtype``), 'types' the
    type-indexed tables of the v2 kernel path (:func:`dfire_type_tables`),
    'auto' picks 'types' for float32 and 'gather' for float64 (the original
    picks 'steps' for float32; see the module docstring).
    """
    method = receptor.method
    mem_mask = np.zeros(receptor.num_atoms, dtype=dtype)
    mem_mask[receptor.membrane] = 1.0
    p = BatchScoringParams(
        method=method,
        use_anm=use_anm,
        rec_coords=receptor.coordinates.astype(dtype),
        rec_nmodes=receptor.nmodes.astype(dtype),
        rec_res_onehot=_res_onehot(receptor).astype(dtype),
        rec_membrane_mask=mem_mask,
        rec_num_membrane=int(receptor.membrane.size),
        lig_coords=ligand.coordinates.astype(dtype),
        lig_nmodes=ligand.nmodes.astype(dtype),
        lig_res_onehot=_res_onehot(ligand).astype(dtype),
    )
    if method == "dfire":
        if dfire_mode == "auto":
            dfire_mode = "types" if np.dtype(dtype) == np.float32 else "gather"
        if dfire_mode not in ("gather", "steps", "types"):
            raise ValueError(f"dfire_mode must be 'auto', 'gather', 'steps' "
                             f"or 'types', got {dfire_mode!r}")
        p.atom_types_rec = receptor.atom_types.astype(np.int32)
        p.atom_types_lig = ligand.atom_types.astype(np.int32)
        pot = potential if potential is not None else potentials.load_potential()
        # The table stays f64 on the host: derived tables difference at
        # full precision; the upload casts to the run dtype.
        p.potential = pot.astype(np.float64)
        d2b = tables.dfire_tables()["dist_to_bins"]
        p.dist_to_bins = d2b.astype(np.int32)
        if dfire_mode == "steps":
            p.dfire_dq, p.dfire_thresholds = dfire_step_tables(
                p.atom_types_rec, p.atom_types_lig, pot, d2b, dtype=dtype)
        elif dfire_mode == "types":
            p.dfire_rec_half, p.dfire_lig_onehot, p.dfire_thresholds = (
                dfire_type_tables(p.atom_types_rec, p.atom_types_lig, pot,
                                  d2b, dtype=np.float64))
    else:
        p.ele_rec = receptor.ele_charges.astype(dtype)
        p.ele_lig = ligand.ele_charges.astype(dtype)
        p.vdw_c_rec = receptor.vdw_charges.astype(dtype)
        p.vdw_c_lig = ligand.vdw_charges.astype(dtype)
        p.vdw_r_rec = receptor.vdw_radii.astype(dtype)
        p.vdw_r_lig = ligand.vdw_radii.astype(dtype)
    return p


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def torch_params(params: BatchScoringParams, device,
                 dtype: torch.dtype) -> BatchScoringParams:
    """Copy ``params`` with every array field as a contiguous tensor on
    ``device`` (a kernel reads it as laid out, with no copy a call)."""
    if dtype not in _NP_DTYPE:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    np_dtype = _NP_DTYPE[dtype]

    def conv(x):
        if x is None:
            return None
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(np_dtype)
        else:
            x = x.astype(np.int64)
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return dataclasses.replace(
        params, **{name: conv(getattr(params, name)) for name in _ARRAY_FIELDS})
