"""Tiling helpers of the kernel path.

The host-side (NumPy) helpers are copies of the reference's, which live in
modules that import JAX at the top (``lightdock_tpu/ops/pallas_energy.py``
and ``lightdock_tpu/engine/energy_pallas.py``).  Each copy is held equal to
its original by ``tests/test_torch_tiling.py``; change both or neither.
The torch helpers at the end (:func:`check_pose_bits`,
:func:`expand_pose_bits`, :func:`tile_sums`) serve the plain versions of
the kernels with per-pose tile bits (K4 and K5).

The tile shape is the port's own (see ``csrc/dfire_pairs.cu``): 32
receptor atoms by 128 ligand atoms per kernel tile, with cull sub-boxes of
8 x 32 atoms nested inside by the RCB order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..engine.params import BatchScoringParams

R_TILE = 32
L_TILE = 128
R_SUB = 8
L_SUB = 32


def rcb_order(coords: np.ndarray, tile) -> np.ndarray:
    """Recursive-coordinate-bisection atom permutation, tile-aware
    (copy of ``pallas_energy.rcb_order``): splits along the widest axis at
    a multiple-of-``tile`` boundary until each chunk holds at most ``tile``
    atoms; a descending tuple nests finer chunks inside coarser ones."""
    tiles = tuple(tile) if isinstance(tile, (tuple, list)) else (tile,)
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    out = np.empty(n, dtype=np.int64)
    pos = 0

    def rec(idx, level):
        nonlocal pos
        m = idx.size
        t = tiles[level]
        if m <= t:
            if level + 1 < len(tiles):
                rec(idx, level + 1)
            else:
                out[pos:pos + m] = idx
                pos += m
            return
        c = coords[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        left_tiles = (-(-m // t)) // 2
        cut = left_tiles * t
        rec(order[:cut], level)
        rec(order[cut:], level)

    rec(np.arange(n), 0)
    return out


def tile_boxes(coords: np.ndarray, tile: int):
    """Per-tile axis-aligned bounding boxes (centers (nT, 3), half extents
    (nT, 3)); all-padding tiles get half extent -inf (copy of
    ``pallas_energy.tile_boxes``)."""
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    pad = (-n) % tile
    real = np.ones(n + pad, dtype=bool)
    real[n:] = False
    c = np.pad(coords, ((0, pad), (0, 0)))
    c_t = c.reshape(-1, tile, 3)
    real_t = real.reshape(-1, tile)[..., None]
    lo = np.where(real_t, c_t, np.inf).min(axis=1)
    hi = np.where(real_t, c_t, -np.inf).max(axis=1)
    empty = ~np.isfinite(lo).all(axis=1)
    centers = np.where(empty[:, None], 0.0, (lo + hi) / 2.0)
    half = np.where(empty[:, None], -np.inf, (hi - lo) / 2.0)
    return centers, half


def anm_mode_bounds(nmodes: np.ndarray) -> np.ndarray:
    """Per-mode maximum atom displacement norm (K,) for the cull slack."""
    nmodes = np.asarray(nmodes, dtype=np.float64)
    if nmodes.shape[0] == 0:
        return np.zeros(0)
    return np.linalg.norm(nmodes, axis=-1).max(axis=1)


def dfire_live_channels(thresholds):
    """Channel indices that can fire inside the 15 A cutoff."""
    return [k for k, s in enumerate(thresholds)
            if k == 0 or s <= C.DFIRE_DIST_CUTOFF2]


def dfire_far_split(thresholds):
    """(split, live): the live-channel index of the far/near boundary
    (about 8 A, beyond the interface cutoff), or None when there are too
    few channels.  Shared by the cull (near bits) and the kernel."""
    live = dfire_live_channels(thresholds)
    iface2 = ((C.INTERFACE_CUTOFF + 1.0) / 2.0) ** 2
    if len(live) < 10:
        return None, live
    cands = [m for m in range(2, len(live) - 2)
             if thresholds[live[m]] > iface2]
    if not cands:
        return None, live
    return min(cands, key=lambda m: abs(thresholds[live[m]] - 64.0)), live


def spatial_sort_params(params: BatchScoringParams,
                        r_tile: int = R_TILE,
                        l_tile: int = L_TILE) -> BatchScoringParams:
    """Permute both atom axes into RCB order (copy of
    ``energy_pallas.spatial_sort_params`` with ``order='rcb'``).  Every
    per-atom array is permuted consistently, so energies are unchanged,
    but tile boxes become compact and the cull bites."""
    pr = rcb_order(params.rec_coords,
                   (r_tile, R_SUB) if r_tile % R_SUB == 0 else r_tile)
    pl_ = rcb_order(params.lig_coords,
                    (l_tile, L_SUB) if l_tile % L_SUB == 0 else l_tile)

    def take(x, axis, perm):
        return None if x is None else np.take(np.asarray(x), perm, axis=axis)

    return dataclasses.replace(
        params,
        rec_coords=take(params.rec_coords, 0, pr),
        rec_nmodes=take(params.rec_nmodes, 1, pr),
        rec_res_onehot=take(params.rec_res_onehot, 1, pr),
        rec_membrane_mask=take(params.rec_membrane_mask, 0, pr),
        lig_coords=take(params.lig_coords, 0, pl_),
        lig_nmodes=take(params.lig_nmodes, 1, pl_),
        lig_res_onehot=take(params.lig_res_onehot, 1, pl_),
        atom_types_rec=take(params.atom_types_rec, 0, pr),
        atom_types_lig=take(params.atom_types_lig, 0, pl_),
        ele_rec=take(params.ele_rec, 0, pr),
        ele_lig=take(params.ele_lig, 0, pl_),
        vdw_c_rec=take(params.vdw_c_rec, 0, pr),
        vdw_c_lig=take(params.vdw_c_lig, 0, pl_),
        vdw_r_rec=take(params.vdw_r_rec, 0, pr),
        vdw_r_lig=take(params.vdw_r_lig, 0, pl_),
        dfire_dq=(None if params.dfire_dq is None
                  else np.asarray(params.dfire_dq)[:, pr][:, :, pl_]),
        dfire_rec_half=take(params.dfire_rec_half, 1, pr),
        dfire_lig_onehot=take(params.dfire_lig_onehot, 1, pl_),
    )


def cull_subsizes(nr: int, nl: int, r_tile: int, l_tile: int):
    """Cull sub-box granularity; falls back to kernel tiles when the fine
    grid would exceed about 2^25 box pairs per 200 poses."""
    r_sub = R_SUB if r_tile % R_SUB == 0 else r_tile
    l_sub = L_SUB if l_tile % L_SUB == 0 else l_tile
    nr_sub = -(-nr // r_sub)
    nl_sub = -(-nl // l_sub)
    if nr_sub * nl_sub * 200 > 2 ** 25:
        r_sub, l_sub = r_tile, l_tile
    return r_sub, l_sub


def pad_box_groups(centers, half, n_tiles, group):
    """Pad sub-box arrays so each kernel tile owns exactly ``group``
    sub-boxes (-inf half extents never fire)."""
    need = n_tiles * group
    pad = need - centers.shape[0]
    if pad > 0:
        centers = np.pad(centers, ((0, pad), (0, 0)))
        half = np.pad(half, ((0, pad), (0, 0)), constant_values=-np.inf)
    return centers, half


def rec_box_geometry(rec_coords, r_tile: int, r_sub: int):
    """Receptor cull-box geometry: sub-boxes of ``r_sub`` atoms padded so
    each kernel tile owns r_tile/r_sub of them."""
    centers, half = tile_boxes(rec_coords, r_sub)
    n_r = -(-rec_coords.shape[0] // r_tile)
    return pad_box_groups(centers, half, n_r, r_tile // r_sub)


def check_pose_bits(rec_all, lig_all, active, iface_active, r_tile, l_tile):
    """Shape checks of the coordinates and per-pose tile bits (n_r, n_l, G)
    that K4 and K5 share; returns (n_r, n_l)."""
    if lig_all.dim() != 3 or lig_all.shape[1] != 3:
        raise ValueError(f"lig_all must be (G, 3, Nl), got {tuple(lig_all.shape)}")
    g, _, nl = lig_all.shape
    if rec_all.dim() != 3 or rec_all.shape[2] != 3 or rec_all.shape[0] not in (1, g):
        raise ValueError(f"rec_all {tuple(rec_all.shape)} is neither rigid "
                         f"(1, Nr, 3) nor per pose ({g}, Nr, 3)")
    n_r, n_l = -(-rec_all.shape[1] // r_tile), -(-nl // l_tile)
    for name, bits in (("active", active), ("iface_active", iface_active)):
        if tuple(bits.shape) != (n_r, n_l, g):
            raise ValueError(f"{name} {tuple(bits.shape)} != {(n_r, n_l, g)}")
    return n_r, n_l


def expand_pose_bits(bits, r_tile, l_tile):
    """(n_r, n_l, P) per-pose tile bits as a (P, Nr_pad, Nl_pad) mask."""
    return (bits.permute(2, 0, 1) != 0).repeat_interleave(
        r_tile, 1).repeat_interleave(l_tile, 2)


def tile_sums(contrib, n_r, r_tile, n_l, l_tile):
    """(P,) sums of (P, Nr_pad, Nl_pad) pair terms: each tile's sum, then
    the tiles in tile order, as the kernels add them.  (One reduction over
    whole poses gave repeats on the CPU that differed in the last bits.)"""
    p = contrib.shape[0]
    tiles = contrib.reshape(p, n_r, r_tile, n_l, l_tile).sum(dim=(2, 4))
    return tiles.reshape(p, n_r * n_l).sum(dim=1)
