"""Kernel energy path: the per-step preparation around the pair kernels.

Port of ``lightdock_tpu/engine/energy_pallas.py`` ``make_pallas_energy_fn``
(its ``energy_fn`` and ``_compute``), ``resolve_kernel`` and
``pose_chunked_energy`` for all three methods, rigid or with ANM:
rotation, the re-centred ligand (G, 3, Nl) with its ANM displacement, the
receptor (1, Nr, 3), or (G, Nr, 3) with receptor ANM (the mode sums and
their slack inside the span ``anm_pose`` while a recorder is active, where
a side has modes), the box cull with ANM slack at the method's energy,
interface and (v2) near cutoffs, sub-box to tile coarsening and the moved
gate (``ops.cull.cull_tile_bits``: one kernel on the card, which also
fills the counters ``cull_checked`` and ``cull_kept`` while a recorder is
active), the moved-first + Morton pose order and its inverse, then the
kernel, the affine finish and the restraint bias.

Two kernel generations, as in JAX.  'v2' ORs the energy and near bits over
each 16-pose chunk and runs ``ops.dfire_pairs`` K1 or
``ops.dfire_pairs_worklist`` K2 for DFIRE (type-indexed tables),
``ops.elec_vdw_pairs`` K3 for DNA and PYDOCK.  'v1' keeps both bits per
pose and runs ``ops.dfire_pairs_v1`` K4 (the (K, Nr, Nl) step tables) or
``ops.elec_vdw_pairs_v1`` K5.

The tile shape is the GPU's own (``ops.tiling.R_TILE`` x ``L_TILE``, 16
poses a chunk); the TPU's tile picker and VMEM pose cap do not apply.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..ops import quaternion as qt
from ..ops.cull import chunk_or, cull_tile_bits, morton_key, pose_slack
from ..ops.dfire_pairs import dfire_pairs, dfire_pairs_worklist, dfire_tables
from ..ops.dfire_pairs_v1 import dfire_pairs_v1
from ..ops.elec_vdw_pairs import elec_vdw_pairs
from ..ops.elec_vdw_pairs_v1 import elec_vdw_pairs_v1
from ..ops.tiling import (L_TILE, R_TILE, anm_mode_bounds, cull_subsizes,
                          pad_box_groups, rec_box_geometry,
                          spatial_sort_params, tile_boxes)
from ..utils import metrics
from .energy_dense import bias, finalize_raw, mode_sum, rotate_translate
from .params import BatchScoringParams, ensure_dfire_steps, ensure_dfire_types

# The JAX rule (``pallas_energy.V2_WORKLIST_MIN_TILES``): DFIRE grids of at
# least this many tile pairs take the work-list kernel K2.
WORKLIST_MIN_TILES = 512


def use_worklist(n_r: int, n_l: int) -> bool:
    """Whether the DFIRE path takes K2 on an n_r x n_l tile grid."""
    return n_r * n_l >= WORKLIST_MIN_TILES


def resolve_kernel(params: BatchScoringParams, kernel: str = "auto") -> str:
    """'auto' -> 'v2' wherever its inputs exist: always for DNA and PYDOCK,
    for DFIRE when the type-indexed tables are present
    (``engine.params.ensure_dfire_types``), else 'v1', which needs the
    (K, Nr, Nl) step tables (copy of ``energy_pallas.resolve_kernel``)."""
    if kernel != "auto":
        return kernel
    if params.method != "dfire":
        return "v2"
    return "v2" if params.dfire_rec_half is not None else "v1"


def kernel_params(params: BatchScoringParams, kernel: str = "v2") -> BatchScoringParams:
    """``params`` as the kernel path takes them, with both atom axes in RCB
    order so the tile cull bites (energies are unchanged).  For 'v2' DFIRE
    takes the type-indexed tables without the redundant (K, Nr, Nl) dq
    tensor; for 'v1' the step tables its kernel reads, built where
    ``params`` lacks them."""
    if params.method == "dfire" and kernel == "v2":
        params = dataclasses.replace(ensure_dfire_types(params), dfire_dq=None)
    elif kernel == "v1":
        params = ensure_dfire_steps(params)
    return spatial_sort_params(params)


def frame_center(params: BatchScoringParams) -> np.ndarray:
    """The frame the kernel path works in: the receptor's mean, taken in
    f64.  Distances are translation-invariant; re-centring keeps the
    coordinates small."""
    return np.asarray(params.rec_coords, dtype=np.float64).mean(axis=0)


def make_kernel_energy_fn(params: BatchScoringParams, device,
                          dtype: torch.dtype = torch.float32,
                          cull: bool = True, worklist: Optional[bool] = None,
                          kernel: str = "auto", shard_parts: bool = False,
                          center=None, rec_bounds=None):
    """Build ``energy_fn(p, t, q, a_rec, a_lig, moved=None,
    prev_scoring=None) -> (G,)``.

    ``params`` is the NumPy ``BatchScoringParams`` (spatially sorted, see
    :func:`kernel_params`); the cull boxes and the v2 DFIRE kernel's tables
    are built from it once, on ``device`` at ``dtype``.  ``p``, given at
    each call, is the same complex as tensors
    (``engine.params.torch_params``).

    ``kernel`` is 'v1', 'v2' or 'auto' (:func:`resolve_kernel`).  v2 DFIRE
    needs the type-indexed tables and runs K1 or, with ``worklist`` true,
    K2; ``worklist=None`` picks K2 for grids of at least
    ``WORKLIST_MIN_TILES`` tile pairs (the JAX rule, on the port's tiles).
    v1 DFIRE needs the step tables (``dfire_mode='steps'``) and reads
    ``p.dfire_dq``, float32 or bfloat16.  The chosen kernel's wrapper is
    ``energy_fn.kernel``.

    ``shard_parts`` builds the receptor-atom-sharded variant
    (``parallel.sharded.make_kernel_atom_sharded_fns``; JAX's
    ``shard_parts=True``): ``params`` holds one shard of the receptor, and
    ``parts_fn(p, t, q, a_rec, a_lig, moved=None) -> (raw, iface_rec,
    iface_lig)`` returns the kernel's raw sums and the flags trimmed to the
    shard's Nr and the Nl atoms (None without restraints or membrane), in
    the caller's pose order, before the affine finish and the bias; a pose
    that ``moved`` leaves out scores no pair, and the caller keeps its
    stored score after combining the shards.  ``center`` (the frame, 3
    coordinates) and ``rec_bounds`` (the receptor's per-mode displacement
    bounds) default to ``params``' own; a shard takes the whole receptor's,
    so every shard works in one frame with the same cull slack.
    """
    dfire = params.method == "dfire"
    rec_anm = params.use_anm and params.rec_nmodes.shape[0] > 0
    lig_anm = params.use_anm and params.lig_nmodes.shape[0] > 0
    kernel_gen = resolve_kernel(params, kernel)
    if kernel_gen not in ("v1", "v2"):
        raise ValueError(f"kernel must be 'v1', 'v2' or 'auto', got {kernel!r}")
    v1 = kernel_gen == "v1"
    if dfire and v1 and params.dfire_dq is None:
        raise ValueError("the v1 DFIRE kernel needs the step tables "
                         "(dfire_mode='steps')")
    if dfire and not v1 and params.dfire_rec_half is None:
        raise ValueError("the DFIRE kernel needs the type-indexed tables "
                         "(engine.params.ensure_dfire_types)")
    if worklist and (v1 or not dfire):
        raise ValueError("the work-list kernel (K2) scores DFIRE only, with "
                         f"the v2 kernels, not {params.method} {kernel_gen}")
    r_tile, l_tile = R_TILE, L_TILE
    nr = params.rec_coords.shape[0]
    nl = params.lig_coords.shape[0]
    r_sub, l_sub = cull_subsizes(nr, nl, r_tile, l_tile)
    n_r = -(-nr // r_tile)
    n_l = -(-nl // l_tile)
    if v1:
        kernel = dfire_pairs_v1 if dfire else elec_vdw_pairs_v1
    elif not dfire:
        kernel = elec_vdw_pairs
    elif worklist or (worklist is None and use_worklist(n_r, n_l)):
        kernel = dfire_pairs_worklist
    else:
        kernel = dfire_pairs
    rg, lg = r_tile // r_sub, l_tile // l_sub
    # Cull boxes of r_sub x l_sub atoms, nested in the kernel tiles by the
    # RCB order; bits are OR-reduced to tiles each step.
    rc, rh = rec_box_geometry(params.rec_coords, r_tile, r_sub)
    lc, lh = pad_box_groups(*tile_boxes(params.lig_coords, l_sub), n_l, lg)
    # Interface flags feed only the restraint and membrane bias.
    need_iface = (params.rec_res_onehot.shape[0] > 0
                  or params.lig_res_onehot.shape[0] > 0
                  or params.rec_num_membrane > 0)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    thresholds = (tuple(float(x) for x in np.asarray(params.dfire_thresholds,
                                                      np.float64))
                  if dfire else None)
    if v1:
        # Energy and interface (DFIRE: d <= 3.9 on the scaled distance)
        # cutoffs; no near bits.
        cuts = ([15.0, (C.INTERFACE_CUTOFF + 1.0) / 2.0] if dfire
                else [C.ELEC_DIST_CUTOFF, C.INTERFACE_CUTOFF])
    elif dfire:
        tables = dfire_tables(tensor(params.dfire_rec_half),
                              tensor(params.dfire_lig_onehot), thresholds,
                              r_tile, l_tile)
        # Energy, interface and, where the tables have a far split, near
        # cutoffs.
        cuts = [15.0, (C.INTERFACE_CUTOFF + 1.0) / 2.0]
        if tables.split is not None:
            cuts.append(float(np.sqrt(tables.thresholds[tables.split])))
    else:
        # Elec reach, interface, and the vdw reach that splits near chunks
        # from elec-only far ones.
        cuts = [C.ELEC_DIST_CUTOFF, C.INTERFACE_CUTOFF, C.VDW_DIST_CUTOFF]
    rc, rh, lc, lh = tensor(rc), tensor(rh), tensor(lc), tensor(lh)
    # v2 ORs the energy and near bits over pose chunks; the interface bits,
    # and every bit of v1, stay per pose.
    chunked = tuple(not v1 and k != 1 for k in range(len(cuts)))
    center = tensor(frame_center(params) if center is None else center)
    # Per-mode displacement bounds widen the boxes by each pose's slack.
    rec_bounds = tensor(anm_mode_bounds(params.rec_nmodes) if rec_bounds is None
                        else rec_bounds)
    lig_bounds = tensor(anm_mode_bounds(params.lig_nmodes))

    def pose_order(t, moved):
        """(order, inverse): poses moved first (where ``moved`` is given),
        Morton order of the translation within each group."""
        key = morton_key(t)
        if moved is not None:
            key = key + torch.logical_not(moved).to(torch.int64) * (1 << 32)
        order = torch.sort(key, stable=True).indices
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return order, inv

    def energy_fn(p: BatchScoringParams, t, q, a_rec, a_lig,
                  moved=None, prev_scoring=None):
        """(G,) scores.  Poses go to the kernel moved first, then in Morton
        order of the translation, and come back in their own order: unmoved
        poses fill whole chunks the kernel skips (their stored score passes
        through), and coherent chunks keep the chunk cull bits tight."""
        if prev_scoring is None:
            moved = None
        order, inv = pose_order(t, moved)
        gate = moved[order] if moved is not None else None
        scores = _compute(p, t[order], q[order], a_rec[order], a_lig[order],
                          gate)[inv]
        if gate is None:
            return scores
        return torch.where(moved, scores, prev_scoring)

    def parts_fn(p: BatchScoringParams, t, q, a_rec, a_lig, moved=None):
        """(raw (G,), iface_rec (G, Nr) or None, iface_lig (G, Nl) or None)
        of this shard, in the caller's pose order (see ``shard_parts``)."""
        order, inv = pose_order(t, moved)
        gate = moved[order] if moved is not None else None
        args, kwargs = kernel_args(p, t[order], q[order], a_rec[order],
                                   a_lig[order], gate)
        raw, ifr, ifl = kernel(*args, **kwargs)
        if ifr is None:
            return raw[inv], None, None
        return raw[inv], ifr[inv, :nr], ifl[inv, :nl]

    def kernel_args(p: BatchScoringParams, t, q, a_rec, a_lig, moved=None):
        """(args, kwargs) of the kernel call (``energy_fn.kernel``) that
        scores poses (t, q, a_rec, a_lig) in the order given."""
        g = t.shape[0]
        rot = qt.rotation_matrix(q)
        lig = rotate_translate(rot, p.lig_coords, t - center[None, :])  # (G, 3, Nl)
        rec = (p.rec_coords - center[None, :])[None]                     # (1, Nr, 3)
        slack = None
        if lig_anm or rec_anm:
            with metrics.span("anm_pose"):
                if lig_anm:
                    lig = lig + mode_sum(a_lig, p.lig_nmodes).transpose(1, 2)
                if rec_anm:
                    rec = rec + mode_sum(a_rec, p.rec_nmodes)            # (G, Nr, 3)
                if cull:
                    slack = pose_slack(a_rec, rec_bounds) if rec_anm else None
                    if lig_anm:
                        ls = pose_slack(a_lig, lig_bounds)
                        slack = ls if slack is None else slack + ls
        if cull:
            bits, counts = cull_tile_bits(rc, rh, lc, lh, t, rot, slack, cuts, (rg, lg),
                                          chunked, moved, count=metrics.recording())
            if counts is not None:
                metrics.count("cull_checked", counts[:, 0])
                metrics.count("cull_kept", counts[:, 1])
        else:
            bits = [torch.ones((n_r, n_l, g), dtype=torch.int32,
                               device=t.device)] * len(cuts)
            if moved is not None:
                bits = [b * moved.to(torch.int32)[None, None, :] for b in bits]
            bits = [chunk_or(b) if c else b for b, c in zip(bits, chunked)]
        kwargs = dict(r_tile=r_tile, l_tile=l_tile, need_iface=need_iface)
        if v1:   # per-pose bits, no chunks
            if dfire:
                return (rec, lig, p.dfire_dq, thresholds, *bits), kwargs
            return ((rec, lig, p.ele_rec, p.ele_lig, p.vdw_c_rec, p.vdw_c_lig,
                     p.vdw_r_rec, p.vdw_r_lig, *bits), kwargs)
        act_chunks, act_iface = bits[0], bits[1]
        kwargs["near_chunks"] = bits[2] if len(bits) > 2 else None
        if dfire:
            return (rec, lig, tables, act_chunks, act_iface), kwargs
        return ((rec, lig, p.ele_rec, p.ele_lig, p.vdw_c_rec, p.vdw_c_lig,
                 p.vdw_r_rec, p.vdw_r_lig, act_chunks, act_iface), kwargs)

    def _compute(p: BatchScoringParams, t, q, a_rec, a_lig, moved):
        args, kwargs = kernel_args(p, t, q, a_rec, a_lig, moved)
        raw, ifr, ifl = kernel(*args, **kwargs)
        score = finalize_raw(p, raw)
        if ifr is None:
            return score
        return bias(p, score, ifr[:, :nr], ifl[:, :nl])

    fn = parts_fn if shard_parts else energy_fn
    fn.kernel_args = kernel_args
    fn.kernel = kernel
    return fn


def pose_chunked_energy(energy_fn, max_chunk: Optional[int] = None):
    """``energy_fn`` over at most ``max_chunk`` poses a call (port of
    ``energy_pallas.pose_chunked_energy``); None scores every pose in one
    call.  The chunks are ceil-balanced (37 poses at 16 go as 3 x 16, 6400
    at 2048 as 4 x 1600), the padding poses repeat the last real pose
    (finite coordinates: a zero quaternion rotates to NaN) and count as
    unmoved, and the moved gate passes through each chunk.  The JAX
    default, a cap from the TPU's VMEM budget, does not apply here.
    ``wrapped.kernel`` is ``energy_fn.kernel``."""

    def wrapped(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None):
        n = t.shape[0]
        if max_chunk is None or n <= max_chunk:
            return energy_fn(p, t, q, a_rec, a_lig, moved=moved,
                             prev_scoring=prev_scoring)
        n_chunks = -(-n // max_chunk)
        chunk = -(-(-(-n // n_chunks)) // 8) * 8   # ceil to a multiple of 8
        pad = n_chunks * chunk - n

        def padded(x, edge=True):
            if edge:
                return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
            return torch.cat([x, torch.zeros((pad,) + x.shape[1:],
                                             dtype=x.dtype, device=x.device)])

        args = [padded(t), padded(q), padded(a_rec), padded(a_lig)]
        gate = moved is not None and prev_scoring is not None
        if gate:
            args += [padded(moved, edge=False), padded(prev_scoring)]
        out = []
        for i in range(0, n_chunks * chunk, chunk):
            tc, qc, arc, alc, *rest = (x[i:i + chunk] for x in args)
            kw = dict(moved=rest[0], prev_scoring=rest[1]) if gate else {}
            out.append(energy_fn(p, tc, qc, arc, alc, **kw))
        return torch.cat(out)[:n]

    wrapped.kernel = getattr(energy_fn, "kernel", None)
    return wrapped
