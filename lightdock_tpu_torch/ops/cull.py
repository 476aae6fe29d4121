"""Per-step cull and pose order around the pair kernel, as torch ops.

Port of ``lightdock_tpu/ops/pallas_energy.py`` ``cull_mask_boxes`` and
``pose_slack`` and of ``lightdock_tpu/engine/energy_pallas.py``
``_morton_key``.  On the TPU this was XLA-side work feeding the Pallas
kernel; here it stays plain tensor work feeding the CUDA kernel.
"""

from __future__ import annotations

import torch


def cull_mask_boxes(rec_centers, rec_half, lig_centers_base, lig_half,
                    t, rot, rec_slack, lig_slack, cutoffs):
    """Box-based cull masks, one (nR, nL, G) int32 tensor per cutoff.

    The receptor box is static; the ligand box is rotated and re-projected
    on the world axes (half extent |R_g| h).  The per-axis gap
    max(0, |c_rec - (R_g c_lig + t_g)| - (h_rec + |R_g| h_lig + slack))
    lower-bounds every atom-pair distance component, so a tile pair whose
    sum(gap^2) exceeds cutoff^2 provably holds no pair inside the cutoff.

    Padding boxes (half extent -inf) are masked out explicitly: |R| @ -inf
    gives NaN wherever a rotation entry is zero, so the gap is computed on
    sanitised extents and a validity mask forces padded pairs inactive.
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
    d2_lb = torch.where(valid, d2_lb, torch.full_like(d2_lb, float("inf")))
    return [(d2_lb <= float(c) ** 2).permute(1, 2, 0).to(torch.int32)
            for c in cutoffs]


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
