"""DFIRE pair kernels K1 and K2: the Hopper kernels, their plain versions,
their tables.

Port of ``lightdock_tpu/ops/pallas_energy.py`` ``dfire_pairs_pallas_v2``
and the two kernels it launches: ``_dfire_kernel_v2`` (K1,
:func:`dfire_pairs`) over the whole tile grid, and ``_dfire_kernel_v2_wl``
(K2, :func:`dfire_pairs_worklist`) over a compacted list of the tiles that
have any active chunk.  The kernel source is ``csrc/dfire_pairs.cu``; its
header note says what bounds the kernels on the card and what the design
does about it.

Contract (all four functions): for poses ``lig_all`` (G, 3, Nl) and a
receptor ``rec_all``, rigid (1, Nr, 3) or per pose (G, Nr, 3) with
receptor ANM, both re-centred, return

* ``raw`` (G,): sum over atom pairs with d2 <= 225 of the cumulative
  DFIRE potential at the bin of d2, over the (receptor tile, ligand tile,
  pose chunk) triples whose ``active_chunks`` bit is 1;
* ``iface_rec`` (G, Nr_pad) and ``iface_lig`` (G, Nl_pad): 1.0 where the
  atom has a partner within d2 <= 2.45^2, in tiles whose chunk is active
  and has at least one pose with its ``iface_active`` bit set; or
  ``None, None`` when ``need_iface`` is false.

K1 adds the tiles' sums in tile order, K2 in work-list order (the listed
tiles ascending), so the two agree within tolerance, not bit for bit.
When no chunk is active, K2's list is empty, ``raw`` is zero and the flags
are empty.

Padding is the reference's: poses are padded to the chunk at 1e6 (both
molecules, for a per-pose receptor), receptor atoms at +1e6 and ligand
atoms at -1e6 (their tables are zero); results are cut to the G real
poses.  A chunk-tile whose ``near_chunks`` bit is 0 takes its bins from
the far split up and does no interface work.  The energy path sets the
bit from its box cull, where it is 0 only if no pair is that close, for
the moved poses of the chunk: for them values are unchanged.  An unmoved
pose sharing an active chunk may take a far bin, as in the JAX kernel; the
moved gate discards its score.  The plain versions honour the bits the
same way.

The bin of d2 is the count of thresholds after the first that are <= d2.
The kernels take it from the pair's 0.5 A distance slot (:func:`slot_bins`),
which gives the same bin only where every live threshold is 0 or a slot
edge: the wrappers raise on any other, on the CPU as on the card.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import constants as C
from . import _build
from .tiling import dfire_far_split, dfire_live_channels

POSE_BLOCK = 16     # poses per chunk (the kernel's kPoses)
MAX_CHANNELS = 32   # bins per table row (one 128-byte line in f32)
MAX_R_TILE = 32     # receptor rows a tile (one bit of the kernel's row mask each)
IFACE2 = ((C.INTERFACE_CUTOFF + 1.0) / 2.0) ** 2   # d <= 3.9 on 2*sqrt(d2)-1


class DfireTables(NamedTuple):
    """Per-complex tables of the kernel, built once on the device.

    ``cum[rec_type[i], tb, k]`` is the cumulative DFIRE potential of
    receptor atom i against ligand type tb at live bin k: the prefix sum of
    the live delta channels in ascending order, the addition order of the
    TPU kernel's ``dq_scr``, so the values are bit-identical to it.  The
    table has one row a receptor row class (atoms whose delta rows are
    equal, which is each DFIRE type present), not one a receptor atom, so
    it stays a few MB at any receptor size.  Row ``n_classes`` is zero and
    serves padding receptor atoms; column ``tb == T`` is zero and serves
    untyped (padding) ligand atoms.
    """

    cum: torch.Tensor         # (n_classes + 1, T + 1, MAX_CHANNELS)
    rec_type: torch.Tensor    # (Nr_pad,) int32, the row of each receptor atom
    lig_type: torch.Tensor    # (Nl_pad,) int32
    thresholds: tuple         # live squared-distance thresholds, ascending
    split: Optional[int]      # far/near boundary (live index) or None


def dfire_tables(rec_half: torch.Tensor, lig_onehot: torch.Tensor,
                 thresholds, r_tile: int, l_tile: int) -> DfireTables:
    """Build :class:`DfireTables` from the type-factored tables
    ``rec_half`` (K, Nr, T) and ``lig_onehot`` (T, Nl) of
    ``engine.params.dfire_type_tables``, padded to whole tiles.  The
    receptor's row classes are the distinct rows ``rec_half[:, i, :]``."""
    thresholds = tuple(float(x) for x in thresholds)
    live = dfire_live_channels(thresholds)
    if len(live) > MAX_CHANNELS:
        raise ValueError(f"{len(live)} live DFIRE channels; at most "
                         f"{MAX_CHANNELS} are supported")
    split, _ = dfire_far_split(thresholds)
    k, nr, n_types = rec_half.shape
    nl = lig_onehot.shape[1]
    nr_pad = -(-nr // r_tile) * r_tile
    nl_pad = -(-nl // l_tile) * l_tile
    classes, rec_class = torch.unique(rec_half.permute(1, 0, 2).reshape(nr, -1),
                                      dim=0, return_inverse=True)
    n_cls = classes.shape[0]
    classes = classes.reshape(n_cls, k, n_types)
    cum = torch.zeros((n_cls + 1, n_types + 1, MAX_CHANNELS),
                      dtype=rec_half.dtype, device=rec_half.device)
    acc = classes[:, live[0]]
    cum[:n_cls, :n_types, 0] = acc
    for i in range(1, len(live)):
        acc = acc + classes[:, live[i]]
        cum[:n_cls, :n_types, i] = acc
    rec_type = F.pad(rec_class, (0, nr_pad - nr), value=n_cls).to(torch.int32)
    typed = lig_onehot.sum(dim=0) > 0
    types = torch.where(typed, lig_onehot.argmax(dim=0),
                        torch.full_like(typed, n_types, dtype=torch.int64))
    lig_type = F.pad(types, (0, nl_pad - nl), value=n_types).to(torch.int32)
    return DfireTables(cum, rec_type, lig_type,
                       tuple(thresholds[c] for c in live), split)


@functools.lru_cache(maxsize=None)
def slot_bins(thresholds: tuple) -> tuple:
    """The kernels' bin of each 0.5 A distance slot: entry ``m + 1`` is the
    bin (the count of thresholds after the first that are <= the slot's
    lower edge ((m + 1) / 2)^2) of slot m = -1 .. 29, the slots of
    d2 <= 225.  The kernels take a pair's slot from its distance and the
    bin from this table, which equals the threshold count at every d2 only
    where each threshold sits on a slot edge: anything else raises."""
    for t in thresholds[1:]:
        s = round(2.0 * math.sqrt(t)) if t > 0 else 0
        if t != 0 and (s / 2.0) ** 2 != t:
            raise ValueError(f"DFIRE threshold {t!r} is not 0 or a 0.5 A slot "
                             "edge ((m + 1) / 2)^2; the kernels bin by slot")
    n_slots = int(2.0 * math.sqrt(C.DFIRE_DIST_CUTOFF2)) + 1
    return tuple(sum(t <= (s / 2.0) ** 2 for t in thresholds[1:])
                 for s in range(n_slots))


def pad_inputs(rec_all, lig_all, iface_active, r_tile, l_tile):
    """The reference's padding (``dfire_pairs_pallas_v2``,
    ``elec_vdw_pairs_pallas_v2``): poses at 1e6 (a per-pose receptor
    too), receptor atoms at +1e6, ligand atoms at -1e6."""
    g, _, nl = lig_all.shape
    nr = rec_all.shape[1]
    gp = -(-g // POSE_BLOCK) * POSE_BLOCK
    lig = F.pad(lig_all, (0, 0, 0, 0, 0, gp - g), value=1e6)
    lig = F.pad(lig, (0, -(-nl // l_tile) * l_tile - nl), value=-1e6)
    rec = rec_all
    if rec.shape[0] != 1:
        rec = F.pad(rec, (0, 0, 0, 0, 0, gp - rec.shape[0]), value=1e6)
    rec = F.pad(rec, (0, 0, 0, -(-nr // r_tile) * r_tile - nr), value=1e6)
    iface = F.pad(iface_active, (0, gp - g), value=0)
    return rec, lig, iface


def check_bits(active_chunks, near_chunks, iface, n_r, n_l, gp):
    """Shape checks of the cull bits shared by the pair kernels."""
    n_chunks = gp // POSE_BLOCK
    if tuple(active_chunks.shape) != (n_r, n_l, n_chunks):
        raise ValueError(f"active_chunks {tuple(active_chunks.shape)} != "
                         f"{(n_r, n_l, n_chunks)}")
    if near_chunks is not None and tuple(near_chunks.shape) != (n_r, n_l, n_chunks):
        raise ValueError(f"near_chunks {tuple(near_chunks.shape)} != "
                         f"{(n_r, n_l, n_chunks)}")
    if tuple(iface.shape) != (n_r, n_l, gp):
        raise ValueError(f"iface_active {tuple(iface.shape)} != "
                         f"{(n_r, n_l, gp)}")


def _padded(rec_all, lig_all, tables, active_chunks, iface_active,
            near_chunks, r_tile, l_tile):
    """The inputs padded as the kernels take them, with their shapes
    checked."""
    if lig_all.dim() != 3 or lig_all.shape[1] != 3:
        raise ValueError(f"lig_all must be (G, 3, Nl), got {tuple(lig_all.shape)}")
    g = lig_all.shape[0]
    if rec_all.dim() != 3 or rec_all.shape[2] != 3 or rec_all.shape[0] not in (1, g):
        raise ValueError(f"rec_all {tuple(rec_all.shape)} is neither rigid "
                         f"(1, Nr, 3) nor per pose ({g}, Nr, 3)")
    rec, lig, iface = pad_inputs(rec_all, lig_all, iface_active, r_tile, l_tile)
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    if tables.rec_type.shape[0] != nr_pad or tables.lig_type.shape[0] != nl_pad:
        raise ValueError("tables were built for other tiles: rec_type "
                         f"{tuple(tables.rec_type.shape)}, lig_type "
                         f"{tuple(tables.lig_type.shape)}; atoms pad to "
                         f"({nr_pad}, {nl_pad})")
    slot_bins(tables.thresholds)   # raises on thresholds off the slot grid
    check_bits(active_chunks, near_chunks, iface, nr_pad // r_tile,
               nl_pad // l_tile, gp)
    if tables.split is None and near_chunks is not None:
        raise ValueError("near bits need a far split in the tables")
    return rec, lig, iface


def worklist(active_chunks):
    """The work list of K2 as torch ops (the kernel builds its own):
    ``(tiles (n_tiles,) int32, n_active (1,) int32)``, the flat indices
    r * n_l + l of the tiles with any active chunk first, ascending (a
    stable compaction), then the others; no host sync."""
    live = (active_chunks != 0).any(dim=2).reshape(-1)
    order = torch.argsort(torch.logical_not(live).to(torch.int32), stable=True)
    return order.to(torch.int32), live.sum().to(torch.int32).reshape(1)


def _plain(rec_all, lig_all, tables, active_chunks, iface_active, r_tile,
           l_tile, need_iface, near_chunks, tile_order):
    """Both plain versions; ``tile_order`` is None (K1: every tile, in tile
    order) or K2's work list (tiles, n_active)."""
    g = lig_all.shape[0]
    rec, lig, iface = _padded(rec_all, lig_all, tables, active_chunks,
                              iface_active, near_chunks, r_tile, l_tile)
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    n_r, n_l = nr_pad // r_tile, nl_pad // l_tile
    dev, dtype = lig.device, lig.dtype
    t1, kp = tables.cum.shape[1], tables.cum.shape[2]
    base = ((tables.rec_type.to(torch.int64)[:, None] * t1
             + tables.lig_type.to(torch.int64)[None, :]) * kp)   # (Nr, Nl)
    cum = tables.cum.reshape(-1)
    thr = tables.thresholds

    def expand(bits):  # (n_r, n_l) -> (Nr_pad, Nl_pad)
        return bits.repeat_interleave(r_tile, 0).repeat_interleave(l_tile, 1)

    tile_sums = torch.empty((gp, n_r * n_l), dtype=dtype, device=dev)
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
        bins = torch.zeros(d2.shape, dtype=torch.int64, device=dev)
        for k in range(1, len(thr)):
            bins += d2 >= thr[k]
        if near_chunks is not None:   # far chunk-tiles: bins from the split up
            near = expand(near_chunks[:, :, c] != 0)
            bins = torch.where(near, bins, torch.clamp(bins, min=tables.split))
            gate_iface = gate & near
        else:
            gate_iface = gate
        val = torch.take(cum, base[None] + bins)
        contrib = torch.where((d2 <= C.DFIRE_DIST_CUTOFF2) & gate, val,
                              torch.zeros_like(val))
        tile_sums[sl] = contrib.reshape(POSE_BLOCK, n_r, r_tile, n_l,
                                        l_tile).sum(dim=(2, 4)).reshape(POSE_BLOCK, -1)
        if need_iface:
            any_iface = iface[:, :, sl].any(dim=-1)
            close = (d2 <= IFACE2) & (gate_iface & expand(any_iface))
            ifr[sl] = close.any(dim=2).to(dtype)
            ifl[sl] = close.any(dim=1).to(dtype)
    if tile_order is None:
        raw = tile_sums.sum(dim=1)
    else:
        tiles, n_active = tile_order
        listed = torch.arange(tiles.shape[0], device=dev) < n_active
        rows = tile_sums[:, tiles.to(torch.int64)]
        raw = torch.where(listed[None, :], rows, torch.zeros_like(rows)).sum(dim=1)
    if not need_iface:
        return raw[:g], None, None
    return raw[:g], ifr[:g], ifl[:g]


def dfire_pairs_plain(rec_all, lig_all, tables: DfireTables, active_chunks,
                      iface_active, *, r_tile: int, l_tile: int,
                      need_iface: bool = True, near_chunks=None):
    """Plain PyTorch version of K1 (see the module docstring), one pose
    chunk at a time.  Any device, f32 or f64."""
    return _plain(rec_all, lig_all, tables, active_chunks, iface_active,
                  r_tile, l_tile, need_iface, near_chunks, None)


def dfire_pairs_worklist_plain(rec_all, lig_all, tables: DfireTables,
                               active_chunks, iface_active, *, r_tile: int,
                               l_tile: int, need_iface: bool = True,
                               near_chunks=None):
    """Plain PyTorch version of K2: K1's plain version with the tile sums
    added over :func:`worklist`'s first ``n_active`` entries.  Any device,
    f32 or f64."""
    return _plain(rec_all, lig_all, tables, active_chunks, iface_active,
                  r_tile, l_tile, need_iface, near_chunks,
                  worklist(active_chunks))


def _bind(lib, name, n_ptrs):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p])
    return fn


def _launch(rec_all, lig_all, tables, active_chunks, iface_active, r_tile,
            l_tile, need_iface, near_chunks, use_worklist):
    g = lig_all.shape[0]
    if r_tile > MAX_R_TILE or l_tile % POSE_BLOCK:
        raise ValueError(f"unsupported tile ({r_tile}, {l_tile}): r_tile <= "
                         f"{MAX_R_TILE} and l_tile a multiple of {POSE_BLOCK}")
    for name, x in (("rec_all", rec_all), ("lig_all", lig_all),
                    ("cum", tables.cum)):
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is {x.dtype}")
    tensors = [rec_all, lig_all, tables.cum, tables.rec_type, tables.lig_type,
               active_chunks, iface_active] + ([near_chunks] if near_chunks is not None else [])
    dev = lig_all.device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on {x.device}")
    for x in (tables.rec_type, tables.lig_type, active_chunks, iface_active, near_chunks):
        if x is not None and x.dtype != torch.int32:
            raise TypeError(f"index and bit tensors must be int32, got {x.dtype}")
    rec, lig, iface = _padded(rec_all, lig_all, tables, active_chunks,
                              iface_active, near_chunks, r_tile, l_tile)
    rec, lig, iface = rec.contiguous(), lig.contiguous(), iface.contiguous()
    act = active_chunks.contiguous()
    near = near_chunks.contiguous() if near_chunks is not None else None
    cum, rec_type = tables.cum.contiguous(), tables.rec_type.contiguous()
    lig_type = tables.lig_type.contiguous()
    gp, nr_pad, nl_pad = lig.shape[0], rec.shape[1], lig.shape[2]
    n_tiles = (nr_pad // r_tile) * (nl_pad // l_tile)

    partial = torch.empty((n_tiles, gp), dtype=torch.float32, device=dev)
    raw = torch.empty(gp, dtype=torch.float32, device=dev)
    if need_iface:
        ifr = torch.zeros((gp, nr_pad), dtype=torch.float32, device=dev)
        ifl = torch.zeros((gp, nl_pad), dtype=torch.float32, device=dev)
    else:
        ifr = ifl = None
    bins = slot_bins(tables.thresholds)
    slots = (ctypes.c_int32 * len(bins))(*bins)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _build.load("dfire_pairs").lib
    if use_worklist:
        tiles = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        n_active = torch.empty(1, dtype=torch.int32, device=dev)
        fn = _bind(lib, "dfire_pairs_worklist_launch", 14)
        lists = (ptr(tiles), ptr(n_active))
    else:
        fn = _bind(lib, "dfire_pairs_launch", 12)
        lists = ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(rec), ptr(lig), ptr(cum), ptr(rec_type), ptr(lig_type),
                 ptr(act), ptr(iface), ptr(near), *lists, ptr(partial),
                 ptr(raw), ptr(ifr), ptr(ifl), nr_pad, nl_pad, gp, rec.shape[0],
                 r_tile, l_tile, cum.shape[1], cum.shape[2], slots, len(bins),
                 len(tables.thresholds), tables.split or 0,
                 C.DFIRE_DIST_CUTOFF2, IFACE2, stream)
    name = "dfire_pairs_worklist" if use_worklist else "dfire_pairs"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if not need_iface:
        return raw[:g], None, None
    return raw[:g], ifr[:g], ifl[:g]


def _dispatch(wrapper, plain, use_worklist, args, kwargs):
    dev = args[1].device.type
    if dev == "cpu":
        return plain(*args, **kwargs)
    if dev != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not {dev}")
    out = _launch(*args, kwargs["r_tile"], kwargs["l_tile"],
                  kwargs.get("need_iface", True), kwargs.get("near_chunks"),
                  use_worklist)
    wrapper.launches += 1
    return out


def dfire_pairs(rec_all, lig_all, tables: DfireTables, active_chunks,
                iface_active, *, r_tile: int, l_tile: int,
                need_iface: bool = True, near_chunks=None):
    """K1: raw DFIRE sums and interface flags (see the module docstring).

    A CPU tensor takes :func:`dfire_pairs_plain`; a CUDA tensor launches
    ``csrc/dfire_pairs.cu`` (float32 only) and adds one to
    ``dfire_pairs.launches``; any other device raises."""
    return _dispatch(dfire_pairs, dfire_pairs_plain, False,
                     (rec_all, lig_all, tables, active_chunks, iface_active),
                     dict(r_tile=r_tile, l_tile=l_tile, need_iface=need_iface,
                          near_chunks=near_chunks))


def dfire_pairs_worklist(rec_all, lig_all, tables: DfireTables, active_chunks,
                         iface_active, *, r_tile: int, l_tile: int,
                         need_iface: bool = True, near_chunks=None):
    """K2: K1's contract over the work list of active tiles (see the module
    docstring).

    A CPU tensor takes :func:`dfire_pairs_worklist_plain`; a CUDA tensor
    launches the work-list kernels of ``csrc/dfire_pairs.cu`` (float32
    only; the list and its length stay on the device) and adds one to
    ``dfire_pairs_worklist.launches``; any other device raises."""
    return _dispatch(dfire_pairs_worklist, dfire_pairs_worklist_plain, True,
                     (rec_all, lig_all, tables, active_chunks, iface_active),
                     dict(r_tile=r_tile, l_tile=l_tile, need_iface=need_iface,
                          near_chunks=near_chunks))


dfire_pairs.launches = 0
dfire_pairs_worklist.launches = 0
