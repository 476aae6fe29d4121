"""Elec/vdw pair kernel K5 (v1): the Hopper kernel and its plain version.

Port of ``lightdock_tpu/ops/pallas_energy.py`` ``elec_vdw_pairs_pallas``
and the kernel it launches, ``_elec_vdw_kernel``; it scores DNA and PYDOCK
in the v1 mode (``energy_kernel.make_kernel_energy_fn(kernel='v1')``).  The
kernel source is ``csrc/elec_vdw_pairs_v1.cu``; its header note says what
bounds it on the card and what the design does about it.

Contract (both versions): for poses ``lig_all`` (G, 3, Nl), a receptor
``rec_all``, rigid (1, Nr, 3) or per pose (G, Nr, 3) with receptor ANM,
both re-centred, and the per-atom charges ``ele_*``, vdw energies
``vdw_c_*`` and vdw radii ``vdw_r_*``, return

* ``raw`` (G,): for each pose, over the (receptor tile, ligand tile) pairs
  whose ``active`` bit (n_r, n_l, G) is 1, the sum over atom pairs of
  ``elec * 332/4 + vdw`` with
  ``elec = clip(qi qj / d2, ELEC_MIN, ELEC_MAX) * [d2 <= 30^2]`` and
  ``vdw = min(sqrt(ei ej) (p6^2 - 2 p6), 1) * [d2 <= 10^2]``,
  ``p6 = ((ri + rj)^2 / d2)^3``;
* ``iface_rec`` (G, Nr_pad) and ``iface_lig`` (G, Nl_pad): 1.0 where the
  atom has a partner within d2 <= 3.9^2 in a tile whose ``active`` and
  ``iface_active`` bits are both 1 for that pose; or ``None, None`` when
  ``need_iface`` is false.

Every bit is per pose and per tile; every pair takes both terms (no
elec-only branch).  The math is unguarded like the reference: at d2 == 0
the elec term clamps (or goes NaN against a zero charge) and vdw goes NaN
through inf - inf; the clamps and the cutoff masks (multiplies) carry NaN
through.  Padding is the reference's: receptor atoms at +1e6, ligand atoms
at -1e6, padded atoms with charge 0, vdw energy 0 and radius 1.

On a CPU tensor :func:`elec_vdw_pairs_v1` runs
:func:`elec_vdw_pairs_v1_plain`; on a CUDA tensor it launches the kernel or
raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import constants as C
from . import _build, counts_launches
from .dfire_pairs import pad_inputs
from .elec_vdw_pairs import ELEC_SCALE, _pad_atoms, check_tile
from .tiling import check_pose_bits, expand_pose_bits, tile_sums

PLAIN_POSES = 16   # poses per step of the plain version's loop


def _check(rec_all, lig_all, atoms, active, iface_active, r_tile, l_tile):
    """Shape checks shared by both versions of K5; returns (n_r, n_l)."""
    n_r, n_l = check_pose_bits(rec_all, lig_all, active, iface_active, r_tile, l_tile)
    nr, nl = rec_all.shape[1], lig_all.shape[2]
    for x, n in zip(atoms, (nr, nl) * 3):
        if tuple(x.shape) != (n,):
            raise ValueError(f"per-atom vector of shape {tuple(x.shape)}; "
                             f"the complex has ({nr}, {nl}) atoms")
    return n_r, n_l


def elec_vdw_pairs_v1_plain(rec_all, lig_all, ele_rec, ele_lig, vdw_c_rec,
                            vdw_c_lig, vdw_r_rec, vdw_r_lig, active,
                            iface_active, *, r_tile: int, l_tile: int,
                            need_iface: bool = True):
    """Plain PyTorch version of K5 (see the module docstring),
    ``PLAIN_POSES`` poses at a time.  Any device, f32 or f64."""
    atoms = (ele_rec, ele_lig, vdw_c_rec, vdw_c_lig, vdw_r_rec, vdw_r_lig)
    n_r, n_l = _check(rec_all, lig_all, atoms, active, iface_active, r_tile, l_tile)
    g, _, nl = lig_all.shape
    nr = rec_all.shape[1]
    nr_pad, nl_pad = n_r * r_tile, n_l * l_tile
    dtype, dev = lig_all.dtype, lig_all.device
    lig = F.pad(lig_all, (0, nl_pad - nl), value=-1e6)
    rec = F.pad(rec_all, (0, 0, 0, nr_pad - nr), value=1e6)
    qr, ql, vcr, vcl, vrr, vrl = _pad_atoms(*atoms, r_tile, l_tile)
    # Pair parameters, shared by every pose.
    qq = qr[:, None] * ql[None, :]
    ve = torch.sqrt(vcr[:, None] * vcl[None, :])
    vr = vrr[:, None] + vrl[None, :]
    vr2 = vr * vr

    raw = torch.empty(g, dtype=dtype, device=dev)
    ifr = torch.zeros((g, nr_pad), dtype=dtype, device=dev)
    ifl = torch.zeros((g, nl_pad), dtype=dtype, device=dev)
    for c0 in range(0, g, PLAIN_POSES):
        sl = slice(c0, min(c0 + PLAIN_POSES, g))
        lc = lig[sl]                                              # (P, 3, Nl)
        rc = rec if rec.shape[0] == 1 else rec[sl]                # (P|1, Nr, 3)
        dx = lc[:, None, 0, :] - rc[:, :, 0, None]
        dy = lc[:, None, 1, :] - rc[:, :, 1, None]
        dz = lc[:, None, 2, :] - rc[:, :, 2, None]
        d2 = dx * dx + dy * dy + dz * dz                          # (P, Nr, Nl)
        inv = torch.reciprocal(d2)
        elec = torch.clamp(qq * inv, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF)
        elec = elec * (d2 <= C.ELEC_DIST_CUTOFF2).to(dtype)
        p2 = vr2 * inv
        p6 = p2 * p2 * p2
        k = torch.clamp(ve * (p6 * p6 - 2.0 * p6), max=C.VDW_CUTOFF)
        k = k * (d2 <= C.VDW_DIST_CUTOFF2).to(dtype)
        contrib = elec * ELEC_SCALE + k
        gate = expand_pose_bits(active[:, :, sl], r_tile, l_tile)
        contrib = torch.where(gate, contrib, torch.zeros_like(contrib))
        raw[sl] = tile_sums(contrib, n_r, r_tile, n_l, l_tile)
        if need_iface:
            close = ((d2 <= C.INTERFACE_CUTOFF2) & gate
                     & expand_pose_bits(iface_active[:, :, sl], r_tile, l_tile))
            ifr[sl] = close.any(dim=2).to(dtype)
            ifl[sl] = close.any(dim=1).to(dtype)
    if not need_iface:
        return raw, None, None
    return raw, ifr, ifl


def _bind(lib):
    fn = lib.elec_vdw_pairs_v1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    return fn


def _launch(rec_all, lig_all, atoms, active, iface_active, r_tile, l_tile,
            need_iface):
    n_r, n_l = _check(rec_all, lig_all, atoms, active, iface_active, r_tile, l_tile)
    check_tile(r_tile, l_tile)
    dev = lig_all.device
    for x in (rec_all, lig_all) + tuple(atoms):
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {x.dtype}")
    for x in (active, iface_active):
        if x.dtype != torch.int32:
            raise TypeError(f"bit tensors must be int32, got {x.dtype}")
    for x in (rec_all,) + tuple(atoms) + (active, iface_active):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on {x.device}")
    g = lig_all.shape[0]
    # Poses pad to whole 16-pose chunks (at 1e6, never active), atoms to
    # whole tiles.
    rec, lig, iface = pad_inputs(rec_all, lig_all, iface_active, r_tile, l_tile)
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    act = F.pad(active, (0, gp - g)).contiguous()
    rec, lig, iface = rec.contiguous(), lig.contiguous(), iface.contiguous()
    atoms = [x.contiguous() for x in _pad_atoms(*atoms, r_tile, l_tile)]

    partial = torch.empty((n_r * n_l, gp), dtype=torch.float32, device=dev)
    raw = torch.empty(gp, dtype=torch.float32, device=dev)
    if need_iface:
        ifr = torch.zeros((gp, nr_pad), dtype=torch.float32, device=dev)
        ifl = torch.zeros((gp, nl_pad), dtype=torch.float32, device=dev)
    else:
        ifr = ifl = None

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = _bind(_build.load("elec_vdw_pairs_v1").lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(rec), ptr(lig), *(ptr(x) for x in atoms), ptr(act),
                 ptr(iface), ptr(partial), ptr(raw), ptr(ifr), ptr(ifl),
                 nr_pad, nl_pad, gp, rec.shape[0], r_tile, l_tile,
                 C.ELEC_DIST_CUTOFF2, C.VDW_DIST_CUTOFF2, C.INTERFACE_CUTOFF2,
                 C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF, C.VDW_CUTOFF,
                 ELEC_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"elec_vdw_pairs_v1 kernel launch failed: CUDA error {err}")
    elec_vdw_pairs_v1.launches += 1
    if not need_iface:
        return raw[:g], None, None
    return raw[:g], ifr[:g], ifl[:g]


@counts_launches
def elec_vdw_pairs_v1(rec_all, lig_all, ele_rec, ele_lig, vdw_c_rec,
                      vdw_c_lig, vdw_r_rec, vdw_r_lig, active, iface_active,
                      *, r_tile: int, l_tile: int, need_iface: bool = True):
    """K5: raw elec/vdw sums and interface flags with per-pose bits (see
    the module docstring).

    A CPU tensor takes :func:`elec_vdw_pairs_v1_plain`; a CUDA tensor
    launches ``csrc/elec_vdw_pairs_v1.cu`` (float32 only) and adds one to
    ``elec_vdw_pairs_v1.launches``; any other device raises."""
    atoms = (ele_rec, ele_lig, vdw_c_rec, vdw_c_lig, vdw_r_rec, vdw_r_lig)
    dev = lig_all.device.type
    if dev == "cpu":
        return elec_vdw_pairs_v1_plain(rec_all, lig_all, *atoms, active,
                                       iface_active, r_tile=r_tile,
                                       l_tile=l_tile, need_iface=need_iface)
    if dev != "cuda":
        raise ValueError(f"elec_vdw_pairs_v1 runs on cpu or cuda, not {dev}")
    return _launch(rec_all, lig_all, atoms, active, iface_active, r_tile,
                   l_tile, need_iface)
