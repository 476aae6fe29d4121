"""DFIRE pair kernel K4 (the v1 step form): the Hopper kernel and its plain
version.

Port of ``lightdock_tpu/ops/pallas_energy.py`` ``dfire_pairs_pallas`` and
the kernel it launches, ``_dfire_kernel``; the energy path takes it in the
v1 mode (``energy_kernel.make_kernel_energy_fn(kernel='v1')``).  The kernel
source is ``csrc/dfire_pairs_v1.cu``; its header note says what bounds it
on the card and what the design does about it.

Contract (both versions): for poses ``lig_all`` (G, 3, Nl), a receptor
``rec_all``, rigid (1, Nr, 3) or per pose (G, Nr, 3) with receptor ANM,
both re-centred, the step tables ``dq`` (K, Nr, Nl) of
``engine.params.dfire_step_tables`` (float32, or bfloat16 upcast element
by element) and their K squared-distance ``thresholds`` (ascending from
channel 1; channel 0 is the baseline), return

* ``raw`` (G,): for each pose, over the (receptor tile, ligand tile) pairs
  whose ``active`` bit (n_r, n_l, G) is 1, the sum over atom pairs with
  d2 <= 225 of ``dq[0] + sum_k dq[k] [d2 >= s_k]``, the chain added in
  channel order in the working precision;
* ``iface_rec`` (G, Nr_pad) and ``iface_lig`` (G, Nl_pad): 1.0 where the
  atom has a partner within d2 <= 2.45^2 in a tile whose ``active`` and
  ``iface_active`` bits are both 1 for that pose; or ``None, None`` when
  ``need_iface`` is false.

Every bit is per pose and per tile: there are no pose chunks and no near
bits.  Padding is the reference's: receptor atoms at +1e6, ligand atoms at
-1e6, their channels zero, so padded pairs add nothing (the kernel skips
them instead of padding).  d2 is the direct difference ((dx dx + dy dy) +
dz dz), as in the dense oracle; the TPU kernel's |r|^2 + |l|^2 - 2 r.l
form was an MXU device.

The kernel takes a pair's channel from its 0.5 A distance slot
(:func:`.dfire_pairs.slot_bins`), which equals the count of thresholds
passed only where every threshold is 0 or a slot edge ((m + 1) / 2)^2:
:func:`dfire_pairs_v1` raises on any other, on the CPU as on the card
(the JAX kernel takes any ascending thresholds; every table that
``engine.params.dfire_step_tables`` builds lies on the grid).

On a CPU tensor :func:`dfire_pairs_v1` runs :func:`dfire_pairs_v1_plain`;
on a CUDA tensor it launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import constants as C
from . import _build
from .dfire_pairs import IFACE2, MAX_R_TILE, slot_bins
from .tiling import check_pose_bits, expand_pose_bits, tile_sums

MAX_CHANNELS = 32   # thresholds the kernel takes
LIG_BLOCK = 16      # ligand atoms a kernel block (kLig)
PLAIN_POSES = 16    # poses per step of the plain version's loop


def _check(rec_all, lig_all, dq, thresholds, active, iface_active, r_tile,
           l_tile):
    """Shape checks shared by both versions of K4; returns (n_r, n_l)."""
    n_r, n_l = check_pose_bits(rec_all, lig_all, active, iface_active, r_tile, l_tile)
    nr, nl = rec_all.shape[1], lig_all.shape[2]
    if dq.dim() != 3 or tuple(dq.shape[1:]) != (nr, nl):
        raise ValueError(f"dq {tuple(dq.shape)} is not (K, {nr}, {nl})")
    if len(thresholds) != dq.shape[0]:
        raise ValueError(f"{len(thresholds)} thresholds for {dq.shape[0]} channels")
    return n_r, n_l


def dfire_pairs_v1_plain(rec_all, lig_all, dq, thresholds, active,
                         iface_active, *, r_tile: int, l_tile: int,
                         need_iface: bool = True):
    """Plain PyTorch version of K4 (see the module docstring), the select
    chain of the TPU kernel over ``PLAIN_POSES`` poses at a time.  Any
    device; float32 or float64 coordinates."""
    n_r, n_l = _check(rec_all, lig_all, dq, thresholds, active, iface_active,
                      r_tile, l_tile)
    g, _, nl = lig_all.shape
    nr = rec_all.shape[1]
    nr_pad, nl_pad = n_r * r_tile, n_l * l_tile
    dtype, dev = lig_all.dtype, lig_all.device
    lig = F.pad(lig_all, (0, nl_pad - nl), value=-1e6)
    rec = F.pad(rec_all, (0, 0, 0, nr_pad - nr), value=1e6)
    dq = F.pad(dq, (0, nl_pad - nl, 0, nr_pad - nr))
    thr = [float(s) for s in thresholds]

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
        # Baseline, then one select-add a live channel, in channel order;
        # a bfloat16 channel is upcast by the add.
        contrib = dq[0].to(dtype).expand(d2.shape)
        for k in range(1, len(thr)):
            if thr[k] <= C.DFIRE_DIST_CUTOFF2:
                contrib = torch.where(d2 >= thr[k], contrib + dq[k], contrib)
        gate = expand_pose_bits(active[:, :, sl], r_tile, l_tile)
        in_cut = (d2 <= C.DFIRE_DIST_CUTOFF2) & gate
        contrib = torch.where(in_cut, contrib, torch.zeros_like(contrib))
        raw[sl] = tile_sums(contrib, n_r, r_tile, n_l, l_tile)
        if need_iface:
            close = (d2 <= IFACE2) & gate & expand_pose_bits(iface_active[:, :, sl],
                                                             r_tile, l_tile)
            ifr[sl] = close.any(dim=2).to(dtype)
            ifl[sl] = close.any(dim=1).to(dtype)
    if not need_iface:
        return raw, None, None
    return raw, ifr, ifl


def _slot_bins(thresholds):
    """The kernel's channel of each 0.5 A slot (:func:`.dfire_pairs.slot_bins`);
    raises on a threshold that is not 0 or a slot edge ((m + 1) / 2)^2."""
    if not all(math.isfinite(float(s)) for s in thresholds):
        raise ValueError("DFIRE thresholds must be 0 or 0.5 A slot edges; "
                         "the kernel bins by slot")
    return slot_bins(tuple(float(s) for s in thresholds))


def _bind(lib):
    fn = lib.dfire_pairs_v1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(rec_all, lig_all, dq, thresholds, active, iface_active, r_tile,
            l_tile, need_iface):
    n_r, n_l = _check(rec_all, lig_all, dq, thresholds, active, iface_active,
                      r_tile, l_tile)
    if r_tile > MAX_R_TILE or l_tile % LIG_BLOCK:
        raise ValueError(f"unsupported tile ({r_tile}, {l_tile}): r_tile <= "
                         f"{MAX_R_TILE} and l_tile a multiple of {LIG_BLOCK}")
    if len(thresholds) > MAX_CHANNELS:
        raise ValueError(f"{len(thresholds)} channels; at most {MAX_CHANNELS}")
    if any(b < a for a, b in zip(thresholds[1:], thresholds[2:])):
        raise ValueError("the kernel's prefix sums need ascending thresholds")
    bins = _slot_bins(thresholds)
    for name, x in (("rec_all", rec_all), ("lig_all", lig_all)):
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is {x.dtype}")
    if dq.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 dq, got {dq.dtype}")
    for x in (active, iface_active):
        if x.dtype != torch.int32:
            raise TypeError(f"bit tensors must be int32, got {x.dtype}")
    dev = lig_all.device
    for x in (rec_all, dq, active, iface_active):
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on {x.device}")
    if not dq.is_contiguous():   # 30 MB at 1ppe: no copy a call
        raise ValueError("the step tables dq must be contiguous (engine.params."
                         "torch_params uploads them so)")
    rec, lig = rec_all.contiguous(), lig_all.contiguous()
    act, iface = active.contiguous(), iface_active.contiguous()
    g, _, nl = lig.shape
    nr = rec.shape[1]
    nr_pad, nl_pad = n_r * r_tile, n_l * l_tile
    n_rows = -(-nr // r_tile) * -(-nl // LIG_BLOCK)   # partial rows: one a block

    partial = torch.empty((n_rows, g), dtype=torch.float32, device=dev)
    raw = torch.empty(g, dtype=torch.float32, device=dev)
    if need_iface:
        ifr = torch.zeros((g, nr_pad), dtype=torch.float32, device=dev)
        ifl = torch.zeros((g, nl_pad), dtype=torch.float32, device=dev)
    else:
        ifr = ifl = None
    slots = (ctypes.c_int32 * len(bins))(*bins)

    def ptr(x):
        return None if x is None else x.data_ptr()

    fn = _bind(_build.load("dfire_pairs_v1").lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(rec), ptr(lig), ptr(dq), ptr(act), ptr(iface),
                 ptr(partial), ptr(raw), ptr(ifr), ptr(ifl), nr, nl, nr_pad,
                 nl_pad, g, rec.shape[0], r_tile, l_tile,
                 int(dq.dtype == torch.bfloat16), int(need_iface), slots,
                 len(bins), len(thresholds), C.DFIRE_DIST_CUTOFF2, IFACE2, stream)
    if err != 0:
        raise RuntimeError(f"dfire_pairs_v1 kernel launch failed: CUDA error {err}")
    dfire_pairs_v1.launches += 1
    return raw, ifr, ifl


def dfire_pairs_v1(rec_all, lig_all, dq, thresholds, active, iface_active, *,
                   r_tile: int, l_tile: int, need_iface: bool = True):
    """K4: raw DFIRE step-form sums and interface flags (see the module
    docstring).

    A CPU tensor takes :func:`dfire_pairs_v1_plain`; a CUDA tensor launches
    ``csrc/dfire_pairs_v1.cu`` (float32 coordinates, float32 or bfloat16
    ``dq``) and adds one to ``dfire_pairs_v1.launches``; any other device
    raises."""
    args = (rec_all, lig_all, dq, thresholds, active, iface_active)
    dev = lig_all.device.type
    _slot_bins(thresholds)   # the kernel's refusal, on the CPU as on the card
    if dev == "cpu":
        return dfire_pairs_v1_plain(*args, r_tile=r_tile, l_tile=l_tile,
                                    need_iface=need_iface)
    if dev != "cuda":
        raise ValueError(f"dfire_pairs_v1 runs on cpu or cuda, not {dev}")
    return _launch(*args, r_tile, l_tile, need_iface)


dfire_pairs_v1.launches = 0
