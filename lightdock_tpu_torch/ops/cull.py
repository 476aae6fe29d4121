"""Per-step cull and pose order around the pair kernel.

Port of ``lightdock_tpu/ops/pallas_energy.py`` ``cull_mask_boxes`` and
``pose_slack`` and of ``lightdock_tpu/engine/energy_pallas.py``
``_morton_key``.  On the TPU the cull was XLA-side work feeding the Pallas
kernel.  Here :func:`cull_tile_bits` goes from the boxes to the tile bits
the pair kernels take: on CUDA tensors in one kernel
(``csrc/cull_bits.cu``, float32 alone), elsewhere as the chain of tensor operations
:func:`cull_tile_bits_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .dfire_pairs import POSE_BLOCK


def box_d2_lower_bound(rec_centers, rec_half, lig_centers_base, lig_half,
                       t, rot, rec_slack, lig_slack):
    """(G, nR, nL) lower bound on the squared distance between any atom of
    receptor box r and any atom of ligand box l at pose g; inf where either
    box is padding.

    The receptor box is static; the ligand box is rotated and re-projected
    on the world axes (half extent |R_g| h).  The per-axis gap
    max(0, |c_rec - (R_g c_lig + t_g)| - (h_rec + |R_g| h_lig + slack))
    lower-bounds every atom-pair distance component, so a box pair whose
    sum(gap^2) exceeds cutoff^2 provably holds no pair inside the cutoff.

    Padding boxes (half extent -inf) are masked out explicitly: |R| @ -inf
    gives NaN wherever a rotation entry is zero, so the gap is computed on
    sanitised extents and a validity mask forces padded pairs to inf.
    """
    valid_r = torch.isfinite(rec_half).all(dim=-1)                  # (nR,)
    valid_l = torch.isfinite(lig_half).all(dim=-1)                  # (nL,)
    rec_half = torch.where(valid_r[:, None], rec_half,
                           torch.zeros_like(rec_half))
    lig_half = torch.where(valid_l[:, None], lig_half,
                           torch.zeros_like(lig_half))
    # Broadcast products, not matmuls: the bound must stay f32-exact
    # whatever the process's TF32 settings are.
    lc = (rot[:, None] * lig_centers_base[None, :, None, :]).sum(dim=-1) \
        + t[:, None, :]                                             # (G, nL, 3)
    lh = (rot.abs()[:, None] * lig_half[None, :, None, :]).sum(dim=-1)
    slack = (rec_slack + lig_slack)[:, None, None, None]
    diff = (rec_centers[None, :, None, :] - lc[:, None, :, :]).abs()
    reach = rec_half[None, :, None, :] + lh[:, None, :, :] + slack
    gap = torch.clamp(diff - reach, min=0.0)                        # (G, nR, nL, 3)
    d2_lb = (gap * gap).sum(dim=-1)
    valid = valid_r[None, :, None] & valid_l[None, None, :]
    return torch.where(valid, d2_lb, torch.full_like(d2_lb, float("inf")))


def cull_mask_boxes(rec_centers, rec_half, lig_centers_base, lig_half,
                    t, rot, rec_slack, lig_slack, cutoffs):
    """Box-based cull masks, one (nR, nL, G) int32 tensor per cutoff: 1
    where :func:`box_d2_lower_bound` is at most cutoff^2."""
    d2_lb = box_d2_lower_bound(rec_centers, rec_half, lig_centers_base,
                               lig_half, t, rot, rec_slack, lig_slack)
    return [(d2_lb <= float(c) ** 2).permute(1, 2, 0).to(torch.int32)
            for c in cutoffs]


def chunk_or(bits):
    """(n_r, n_l, G) per-pose bits ORed over each ``POSE_BLOCK``-pose chunk:
    (n_r, n_l, ceil(G / POSE_BLOCK))."""
    g = bits.shape[-1]
    gp = -(-g // POSE_BLOCK) * POSE_BLOCK
    bits = F.pad(bits, (0, gp - g))
    return bits.reshape(*bits.shape[:2], gp // POSE_BLOCK, POSE_BLOCK).amax(dim=-1)


def cull_tile_bits_plain(rec_centers, rec_half, lig_centers, lig_half, t, rot,
                         slack, cutoffs, groups, chunked, moved=None):
    """Plain PyTorch version of the cull kernel (see :func:`cull_tile_bits`):
    :func:`cull_mask_boxes` over the sub-boxes, ORed to kernel tiles,
    gated by ``moved``, and ORed over pose chunks where ``chunked`` says.
    Any device and float dtype."""
    rg, lg = groups
    g = t.shape[0]
    n_r, n_l = rec_centers.shape[0] // rg, lig_centers.shape[0] // lg
    if slack is None:
        slack = torch.zeros(g, dtype=t.dtype, device=t.device)
    fine = cull_mask_boxes(rec_centers, rec_half, lig_centers, lig_half, t, rot,
                           slack, torch.zeros_like(slack), cutoffs)
    # OR-reduce sub-boxes to kernel tiles.
    bits = [a.reshape(n_r, rg, n_l, lg, g).amax(dim=(1, 3)) for a in fine]
    if moved is not None:
        bits = [b * moved.to(torch.int32)[None, None, :] for b in bits]
    return [chunk_or(b) if c else b for b, c in zip(bits, chunked)]


def cull_tile_bits(rec_centers, rec_half, lig_centers, lig_half, t, rot, slack,
                   cutoffs, groups, chunked, moved=None, count=False):
    """The box cull's tile bits for the pair kernels: ``(bits, counts)``.

    ``rec_centers`` and ``rec_half`` (n_r * rg, 3) are the receptor's cull
    sub-boxes, ``rg`` of them a kernel tile (``groups`` = (rg, lg)), half
    extents -inf where padding; ``lig_centers`` and ``lig_half``
    (n_l * lg, 3) the ligand's in its own frame; ``t`` (G, 3) and ``rot``
    (G, 3, 3) the poses; ``slack`` (G,) the ANM slack (None: rigid).
    ``bits`` holds one int32 tensor a cutoff: 1 where some sub-box pair of
    the tile pair has :func:`box_d2_lower_bound` at most cutoff^2, 0 for a
    pose that ``moved`` (G,) bool leaves out; (n_r, n_l, G) per pose, or
    (n_r, n_l, ceil(G / 16)) ORed over pose chunks where that cutoff's
    ``chunked`` entry is true.

    CUDA tensors launch ``csrc/cull_bits.cu``, which takes float32 alone
    (anything else raises TypeError), rounds every term toward a lower
    bound (the bits differ from the plain version's only within rounding
    of a cutoff^2, and never drop an entry the exact bound keeps) and adds
    one to ``cull_tile_bits.launches``.  With ``count``, ``counts`` is an
    (n_blocks, 2) int32 tensor the kernel fills: summed over blocks, the
    (pose, tile pair) entries of the poses ``moved`` keeps, and those whose
    first-cutoff bit is 1.  Tensors on any other device take
    :func:`cull_tile_bits_plain`, and ``counts`` is None."""
    if t.device.type != "cuda":
        return cull_tile_bits_plain(rec_centers, rec_half, lig_centers, lig_half,
                                    t, rot, slack, cutoffs, groups, chunked,
                                    moved), None
    out = _launch(rec_centers, rec_half, lig_centers, lig_half, t, rot, slack,
                  cutoffs, groups, chunked, moved, count)
    cull_tile_bits.launches += 1
    return out


cull_tile_bits.launches = 0


def cut2_up(cutoffs):
    """Each cutoff^2 as the float32 at or above its float64 value."""
    out = []
    for c in cutoffs:
        c2 = float(c) ** 2
        f = np.float32(c2)
        out.append(float(np.nextafter(f, np.float32(np.inf)) if float(f) < c2 else f))
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("cull_bits").lib
    lib.cull_bits_launch.restype = ctypes.c_int
    lib.cull_bits_launch.argtypes = ([ctypes.c_void_p] * 12
                                     + [ctypes.POINTER(ctypes.c_float)]
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.cull_bits_grid.restype = ctypes.c_int
    lib.cull_bits_grid.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    return lib


def _launch(rec_centers, rec_half, lig_centers, lig_half, t, rot, slack,
            cutoffs, groups, chunked, moved, count):
    rg, lg = groups
    g, dev = t.shape[0], t.device
    n_cuts = len(cutoffs)
    if not 1 <= n_cuts <= 3 or len(chunked) != n_cuts:
        raise ValueError(f"{n_cuts} cutoffs with {len(chunked)} chunk flags; "
                         "the kernel takes 1 to 3")
    n_r, n_l = rec_centers.shape[0] // rg, lig_centers.shape[0] // lg
    floats = {"rec_centers": (rec_centers, (n_r * rg, 3)),
              "rec_half": (rec_half, (n_r * rg, 3)),
              "lig_centers": (lig_centers, (n_l * lg, 3)),
              "lig_half": (lig_half, (n_l * lg, 3)), "t": (t, (g, 3)),
              "rot": (rot, (g, 3, 3)), "slack": (slack, (g,))}
    for name, (x, shape) in floats.items():
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
        if x is not None and (x.dtype != torch.float32 or x.device != dev):
            raise TypeError(f"the cull kernel takes float32 on {dev}; {name} is "
                            f"{x.dtype} on {x.device}")
    if moved is not None and (moved.dtype != torch.bool or tuple(moved.shape) != (g,)
                              or moved.device != dev):
        raise TypeError(f"moved must be ({g},) bool on {dev}")
    inputs = [None if x is None else x.contiguous()
              for x in (rec_centers, rec_half, lig_centers, lig_half, t, rot, slack, moved)]
    n_chunks = -(-g // POSE_BLOCK)
    bits = [torch.empty((n_r, n_l, n_chunks if c else g), dtype=torch.int32, device=dev)
            for c in chunked]
    lib = _lib()
    counts = None
    if count:
        grid = [ctypes.c_int() for _ in range(3)]
        err = lib.cull_bits_grid(g, n_r, n_l, rg, *(ctypes.byref(x) for x in grid))
        if err != 0:
            raise RuntimeError(f"cull_bits grid refused: CUDA error {err}")
        blocks = grid[0].value * grid[1].value * grid[2].value
        counts = torch.empty((blocks, 2), dtype=torch.int32, device=dev)
    ptrs = [None if x is None else x.data_ptr() for x in inputs + bits + [None] * (3 - n_cuts)
            + [counts]]
    cut2 = (ctypes.c_float * n_cuts)(*cut2_up(cutoffs))
    flags = sum(1 << k for k, c in enumerate(chunked) if c)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cull_bits_launch(*ptrs, cut2, n_cuts, flags, g, n_r, n_l, rg, lg, stream)
    if err != 0:
        raise RuntimeError(f"cull_bits kernel launch failed: CUDA error {err}")
    return bits, counts


def pose_slack(coefs, mode_bounds):
    """Per-pose upper bound on any atom's ANM displacement: (G,)."""
    if mode_bounds.shape[0] == 0:
        return torch.zeros(coefs.shape[0], dtype=coefs.dtype,
                           device=coefs.device)
    return coefs.abs() @ torch.as_tensor(mode_bounds, dtype=coefs.dtype,
                                         device=coefs.device)


def _spread_bits(v):
    """Interleave the low 10 bits of ``v`` with two zero bits each."""
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_key(t):
    """(G,) int64 Morton (Z-curve) key of pose translations, 10 bits per
    axis, quantised over the batch's own bounds.  Only the order matters:
    sorting poses by it makes each kernel pose chunk spatially coherent,
    so the chunk-level cull bits (OR over the chunk) stay tight."""
    tmin = t.min(dim=0).values
    span = t.max(dim=0).values - tmin
    cell = torch.clamp(span / 1023.0, min=1e-9)
    ii = torch.clamp(((t - tmin[None]) / cell[None]).to(torch.int32),
                     0, 1023).to(torch.int64)
    return (_spread_bits(ii[:, 0]) | (_spread_bits(ii[:, 1]) << 1)
            | (_spread_bits(ii[:, 2]) << 2))