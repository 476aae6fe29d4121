"""Elec/vdw pair kernel (K3): the Hopper kernel and its plain version.

Port of ``lightdock_tpu/ops/pallas_energy.py`` ``elec_vdw_pairs_pallas_v2``
and the kernel it launches, ``_elec_vdw_kernel_v2``; it scores DNA and
PYDOCK.  The kernel source is ``csrc/elec_vdw_pairs.cu``; its header note
says what bounds it on the card and what the design does about it.

Contract (both versions): for poses ``lig_all`` (G, 3, Nl) and a receptor
``rec_all``, rigid (1, Nr, 3) or per pose (G, Nr, 3) with receptor ANM,
both re-centred, and the per-atom charges ``ele_*``, vdw energies
``vdw_c_*`` and vdw radii ``vdw_r_*``, return

* ``raw`` (G,): over the (receptor tile, ligand tile, pose chunk) triples
  whose ``active_chunks`` bit is 1, the sum over atom pairs of
  ``elec * 332/4 + vdw`` with
  ``elec = clip(qi qj / d2, ELEC_MIN, ELEC_MAX) * [d2 <= 30^2]`` and
  ``vdw = min(sqrt(ei ej) (p6^2 - 2 p6), 1) * [d2 <= 10^2]``,
  ``p6 = ((ri + rj)^2 / d2)^3``; triples whose ``near_chunks`` bit is 0
  take the elec term alone (the bit says no pair is within 10 A, so vdw
  is zero there);
* ``iface_rec`` (G, Nr_pad) and ``iface_lig`` (G, Nl_pad): 1.0 where the
  atom has a partner within d2 <= 3.9^2, in near triples that are active
  and hold at least one pose with its ``iface_active`` bit set; or
  ``None, None`` when ``need_iface`` is false.

The math is the TPU kernel's and unguarded like the reference: at d2 == 0
the elec term clamps (or goes NaN against a zero charge) and vdw goes NaN
through inf - inf; both clamps and the cutoff masks (multiplies, not
selects) carry NaN through.  Padding is the reference's: poses at 1e6,
receptor atoms at +1e6, ligand atoms at -1e6, padded atoms with charge 0,
vdw energy 0 and radius 1.  A padded pose may go NaN; every reduction is
per pose, and the results are cut to the G real poses.

On a CPU tensor :func:`elec_vdw_pairs` runs :func:`elec_vdw_pairs_plain`;
on a CUDA tensor it launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import constants as C
from . import _build
from .dfire_pairs import POSE_BLOCK, check_bits, pad_inputs

ELEC_SCALE = C.FACTOR / C.EPSILON
MAX_R_TILE = 32              # receptor rows a tile (the kernel's kEvMaxRTile)
KERNEL_L_TILES = (32, 64, 128)   # ligand tiles the kernel takes


def check_tile(r_tile, l_tile):
    """Raises on a tile the kernels (K3 and K5) do not take: at most
    ``MAX_R_TILE`` receptor rows and ``KERNEL_L_TILES`` ligand atoms."""
    if not 0 < r_tile <= MAX_R_TILE or l_tile not in KERNEL_L_TILES:
        raise ValueError(f"unsupported tile ({r_tile}, {l_tile}): r_tile <= "
                         f"{MAX_R_TILE} and l_tile in {KERNEL_L_TILES}")


def _pad_atoms(ele_rec, ele_lig, vdw_c_rec, vdw_c_lig, vdw_r_rec, vdw_r_lig,
               r_tile, l_tile):
    """Per-atom vectors padded to whole tiles: charge and vdw energy 0,
    radius 1 (``elec_vdw_pairs_pallas_v2``)."""
    def pad(x, tile, value):
        return F.pad(x, (0, -(-x.shape[0] // tile) * tile - x.shape[0]),
                     value=value)

    return (pad(ele_rec, r_tile, 0.0), pad(ele_lig, l_tile, 0.0),
            pad(vdw_c_rec, r_tile, 0.0), pad(vdw_c_lig, l_tile, 0.0),
            pad(vdw_r_rec, r_tile, 1.0), pad(vdw_r_lig, l_tile, 1.0))


def _check(rec, lig, atoms, active_chunks, iface, near_chunks, r_tile, l_tile):
    if lig.dim() != 3 or lig.shape[1] != 3:
        raise ValueError(f"lig_all must be (G, 3, Nl), got {tuple(lig.shape)}")
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    for x, n in zip(atoms, (nr_pad, nl_pad) * 3):
        if tuple(x.shape) != (n,):
            raise ValueError(f"per-atom vector of shape {tuple(x.shape)}; "
                             f"atoms pad to ({nr_pad}, {nl_pad})")
    check_bits(active_chunks, near_chunks, iface, nr_pad // r_tile,
               nl_pad // l_tile, gp)


def _padded(rec_all, lig_all, atoms, active_chunks, iface_active,
            near_chunks, r_tile, l_tile):
    g = lig_all.shape[0]
    if rec_all.dim() != 3 or rec_all.shape[2] != 3 or rec_all.shape[0] not in (1, g):
        raise ValueError(f"rec_all {tuple(rec_all.shape)} is neither rigid "
                         f"(1, Nr, 3) nor per pose ({g}, Nr, 3)")
    rec, lig, iface = pad_inputs(rec_all, lig_all, iface_active, r_tile, l_tile)
    atoms = _pad_atoms(*atoms, r_tile, l_tile)
    _check(rec, lig, atoms, active_chunks, iface, near_chunks, r_tile, l_tile)
    return rec, lig, atoms, iface


def elec_vdw_pairs_plain(rec_all, lig_all, ele_rec, ele_lig, vdw_c_rec,
                         vdw_c_lig, vdw_r_rec, vdw_r_lig, active_chunks,
                         iface_active, *, r_tile: int, l_tile: int,
                         need_iface: bool = True, near_chunks=None):
    """Plain PyTorch version of the kernel's contract, one pose chunk at a
    time (see the module docstring).  Any device, f32 or f64."""
    g = lig_all.shape[0]
    rec, lig, (qr, ql, vcr, vcl, vrr, vrl), iface = _padded(
        rec_all, lig_all, (ele_rec, ele_lig, vdw_c_rec, vdw_c_lig, vdw_r_rec,
                           vdw_r_lig),
        active_chunks, iface_active, near_chunks, r_tile, l_tile)
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    n_r, n_l = nr_pad // r_tile, nl_pad // l_tile
    dev, dtype = lig.device, lig.dtype
    # Pair parameters, shared by every pose.
    qq = qr[:, None] * ql[None, :]
    ve = torch.sqrt(vcr[:, None] * vcl[None, :])
    vr = vrr[:, None] + vrl[None, :]
    vr2 = vr * vr

    def expand(bits):  # (n_r, n_l) -> (Nr_pad, Nl_pad)
        return bits.repeat_interleave(r_tile, 0).repeat_interleave(l_tile, 1)

    raw = torch.empty(gp, dtype=dtype, device=dev)
    ifr = torch.zeros((gp, nr_pad), dtype=dtype, device=dev)
    ifl = torch.zeros((gp, nl_pad), dtype=dtype, device=dev)
    for c in range(gp // POSE_BLOCK):
        sl = slice(c * POSE_BLOCK, (c + 1) * POSE_BLOCK)
        lc = lig[sl]                                              # (P, 3, Nl)
        rc = rec if rec.shape[0] == 1 else rec[sl]                # (P|1, Nr, 3)
        dx = lc[:, None, 0, :] - rc[:, :, 0, None]
        dy = lc[:, None, 1, :] - rc[:, :, 1, None]
        dz = lc[:, None, 2, :] - rc[:, :, 2, None]
        d2 = dx * dx + dy * dy + dz * dz                          # (P, Nr, Nl)
        gate = expand(active_chunks[:, :, c] != 0)
        near = (expand(near_chunks[:, :, c] != 0) if near_chunks is not None
                else torch.ones_like(gate))
        inv = torch.reciprocal(d2)
        elec = torch.clamp(qq * inv, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF)
        elec = elec * (d2 <= C.ELEC_DIST_CUTOFF2).to(dtype)
        p2 = vr2 * inv
        p6 = p2 * p2 * p2
        k = torch.clamp(ve * (p6 * p6 - 2.0 * p6), max=C.VDW_CUTOFF)
        k = k * (d2 <= C.VDW_DIST_CUTOFF2).to(dtype)
        contrib = torch.where(near, elec * ELEC_SCALE + k, elec * ELEC_SCALE)
        contrib = torch.where(gate, contrib, torch.zeros_like(contrib))
        tile_sums = contrib.reshape(POSE_BLOCK, n_r, r_tile, n_l, l_tile).sum(dim=(2, 4))
        raw[sl] = tile_sums.reshape(POSE_BLOCK, n_r * n_l).sum(dim=1)
        if need_iface:
            any_iface = expand(iface[:, :, sl].any(dim=-1))
            close = (d2 <= C.INTERFACE_CUTOFF2) & (gate & near & any_iface)
            ifr[sl] = close.any(dim=2).to(dtype)
            ifl[sl] = close.any(dim=1).to(dtype)
    if not need_iface:
        return raw[:g], None, None
    return raw[:g], ifr[:g], ifl[:g]


def _bind(lib):
    fn = lib.elec_vdw_pairs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    return fn


def _launch(rec_all, lig_all, atoms, active_chunks, iface_active, r_tile,
            l_tile, need_iface, near_chunks):
    g = lig_all.shape[0]
    check_tile(r_tile, l_tile)
    dev = lig_all.device
    for x in (rec_all, lig_all) + tuple(atoms):
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {x.dtype}")
    for x in (active_chunks, iface_active, near_chunks):
        if x is not None and x.dtype != torch.int32:
            raise TypeError(f"bit tensors must be int32, got {x.dtype}")
    for x in (rec_all,) + tuple(atoms) + (active_chunks, iface_active, near_chunks):
        if x is not None and x.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on {x.device}")
    rec, lig, atoms, iface = _padded(rec_all, lig_all, atoms, active_chunks,
                                     iface_active, near_chunks, r_tile, l_tile)
    rec, lig, iface = rec.contiguous(), lig.contiguous(), iface.contiguous()
    atoms = [x.contiguous() for x in atoms]
    act = active_chunks.contiguous()
    near = near_chunks.contiguous() if near_chunks is not None else None
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    n_tiles = (nr_pad // r_tile) * (nl_pad // l_tile)

    partial = torch.empty((n_tiles, gp), dtype=torch.float32, device=dev)
    raw = torch.empty(gp, dtype=torch.float32, device=dev)
    if need_iface:
        ifr = torch.zeros((gp, nr_pad), dtype=torch.float32, device=dev)
        ifl = torch.zeros((gp, nl_pad), dtype=torch.float32, device=dev)
    else:
        ifr = ifl = None

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = _bind(_build.load("elec_vdw_pairs").lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(rec), ptr(lig), *(ptr(x) for x in atoms), ptr(act),
                 ptr(iface), ptr(near), ptr(partial), ptr(raw), ptr(ifr),
                 ptr(ifl), nr_pad, nl_pad, gp, rec.shape[0], r_tile, l_tile,
                 C.ELEC_DIST_CUTOFF2, C.VDW_DIST_CUTOFF2, C.INTERFACE_CUTOFF2,
                 C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF, C.VDW_CUTOFF,
                 ELEC_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"elec_vdw_pairs kernel launch failed: CUDA error {err}")
    elec_vdw_pairs.launches += 1
    if not need_iface:
        return raw[:g], None, None
    return raw[:g], ifr[:g], ifl[:g]


def elec_vdw_pairs(rec_all, lig_all, ele_rec, ele_lig, vdw_c_rec, vdw_c_lig,
                   vdw_r_rec, vdw_r_lig, active_chunks, iface_active, *,
                   r_tile: int, l_tile: int, need_iface: bool = True,
                   near_chunks=None):
    """K3: raw elec/vdw sums and interface flags (see the module docstring).

    A CPU tensor takes :func:`elec_vdw_pairs_plain`; a CUDA tensor launches
    ``csrc/elec_vdw_pairs.cu`` (float32 only) and adds one to
    ``elec_vdw_pairs.launches``; any other device raises."""
    atoms = (ele_rec, ele_lig, vdw_c_rec, vdw_c_lig, vdw_r_rec, vdw_r_lig)
    dev = lig_all.device.type
    if dev == "cpu":
        return elec_vdw_pairs_plain(rec_all, lig_all, *atoms, active_chunks,
                                    iface_active, r_tile=r_tile, l_tile=l_tile,
                                    need_iface=need_iface, near_chunks=near_chunks)
    if dev != "cuda":
        raise ValueError(f"elec_vdw_pairs runs on cpu or cuda, not {dev}")
    return _launch(rec_all, lig_all, atoms, active_chunks, iface_active,
                   r_tile, l_tile, need_iface, near_chunks)


elec_vdw_pairs.launches = 0
