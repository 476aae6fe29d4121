"""Dense energies over (G, Nr, Nl): the plain reference.

Port of ``lightdock_tpu/engine/energy_batch.py`` ``batch_pose_coords``,
``_pair_d2``, ``_dfire_parts`` (gather form), ``_dfire_parts_steps``,
``_elec_vdw_parts``, ``finalize_raw``, ``_bias``, ``batch_energy`` and
``batch_energy_parts``, and of the pose chunking of
``lightdock_tpu/engine/gso_jax.py`` ``batch_energy_chunked``, for all three
methods.  It keeps no kernel: it is the oracle the kernel path is checked
against, on the CPU and on the card.

``params`` is a ``BatchScoringParams`` whose arrays are tensors
(``engine.params.torch_params``).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops import quaternion as qt
from ..utils import metrics
from .params import BatchScoringParams

IFACE2 = ((C.INTERFACE_CUTOFF + 1.0) / 2.0) ** 2


def rotate_translate(rot, coords, t):
    """(G, 3, N) = rot (G, 3, 3) applied to coords (N, 3), plus t (G, 3).

    Written as broadcast products, ((R0 x + R1 y) + R2 z) + t, rather than
    a matmul: exact f32 whatever the TF32 settings, and the same rounding
    wherever it is used, so the kernel path and this oracle see the same
    coordinates when given the same frame."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    return torch.stack(
        [rot[:, a, 0, None] * x + rot[:, a, 1, None] * y
         + rot[:, a, 2, None] * z + t[:, a, None] for a in range(3)], dim=1)


def mode_sum(a, nmodes):
    """(G, N, 3) ANM displacement sum_k a[:, k] nmodes[k], added in mode
    order as broadcast products (not an einsum), for the reason
    :func:`rotate_translate` gives."""
    out = a[:, 0, None, None] * nmodes[0]
    for k in range(1, nmodes.shape[0]):
        out = out + a[:, k, None, None] * nmodes[k]
    return out


def batch_pose_coords(p: BatchScoringParams, t, q, a_rec, a_lig):
    """Transformed coordinates: (rec (G, Nr, 3), lig (G, Nl, 3)); the
    mode sums inside the span ``anm_pose`` where a side has modes."""
    rot = qt.rotation_matrix(q)
    lig = rotate_translate(rot, p.lig_coords, t).transpose(1, 2)
    rec = p.rec_coords[None].expand((t.shape[0],) + tuple(p.rec_coords.shape))
    lig_anm = p.use_anm and p.lig_nmodes.shape[0] > 0
    rec_anm = p.use_anm and p.rec_nmodes.shape[0] > 0
    if lig_anm or rec_anm:
        with metrics.span("anm_pose"):
            if lig_anm:
                lig = lig + mode_sum(a_lig, p.lig_nmodes)
            if rec_anm:
                rec = p.rec_coords[None] + mode_sum(a_rec, p.rec_nmodes)
    return rec, lig


def pair_d2(rec, lig):
    """(G, Nr, Nl) squared distances, ((dx^2 + dy^2) + dz^2)."""
    d = [lig[:, None, :, c] - rec[:, :, None, c] for c in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def finalize_raw(p: BatchScoringParams, raw):
    """Affine finish of the raw pair sum: DFIRE's scale and offset, or the
    sign flip of elec/vdw."""
    if p.method == "dfire":
        return (raw * C.DFIRE_SCALE - C.DFIRE_OFFSET) * -1.0
    return raw * -1.0


def bias(p: BatchScoringParams, score, iface_rec, iface_lig):
    """score * (1 + frac_rec + frac_lig) - membrane penalty."""
    def frac(onehot, iface):
        if onehot.shape[0] == 0:
            return torch.zeros_like(score)
        hits = torch.einsum("rn,gn->gr", onehot, iface)
        return (hits > 0).to(score.dtype).mean(dim=1)

    fr = frac(p.rec_res_onehot, iface_rec)
    fl = frac(p.lig_res_onehot, iface_lig)
    if p.rec_num_membrane > 0:
        inter = torch.einsum("n,gn->g", p.rec_membrane_mask,
                             iface_rec) / p.rec_num_membrane
        penalty = C.MEMBRANE_PENALTY_SCORE * inter
    else:
        penalty = torch.zeros_like(score)
    return score + fr * score + fl * score - penalty


def dfire_parts(p: BatchScoringParams, d2):
    """(raw (G,), iface_rec (G, Nr), iface_lig (G, Nl)).  Takes the step
    form when ``p.dfire_dq`` is present, else the reference's gather."""
    if p.dfire_dq is not None:
        return dfire_parts_steps(p, d2)
    mask = d2 <= C.DFIRE_DIST_CUTOFF2
    d = torch.sqrt(torch.where(mask, d2, torch.ones_like(d2))) * 2.0 - 1.0
    slot = torch.clamp(torch.trunc(d), 0, p.dist_to_bins.shape[0] - 1).to(torch.int64)
    bins = p.dist_to_bins[slot] - 1
    idx = (p.atom_types_rec[None, :, None] * (C.DFIRE_NUM_ATOM_TYPES * C.DFIRE_NUM_BINS)
           + p.atom_types_lig[None, None, :] * C.DFIRE_NUM_BINS + bins)
    contrib = p.potential[idx]
    raw = torch.where(mask, contrib, torch.zeros_like(contrib)).sum(dim=(1, 2))
    close = mask & (d <= C.INTERFACE_CUTOFF)
    return raw, close.any(dim=2).to(d2.dtype), close.any(dim=1).to(d2.dtype)


def dfire_parts_steps(p: BatchScoringParams, d2):
    """Step form: baseline dq[0] plus one select-add per threshold."""
    dtype = d2.dtype
    mask = (d2 <= C.DFIRE_DIST_CUTOFF2).to(dtype)
    contrib = p.dfire_dq[0][None].expand(d2.shape).to(dtype)
    for k in range(1, p.dfire_dq.shape[0]):
        contrib = torch.where(d2 >= p.dfire_thresholds[k],
                              contrib + p.dfire_dq[k][None], contrib)
    raw = (contrib * mask).sum(dim=(1, 2))
    close = d2 <= IFACE2
    return raw, close.any(dim=2).to(dtype), close.any(dim=1).to(dtype)


def elec_vdw_parts(p: BatchScoringParams, d2):
    """DNA/PYDOCK (raw, iface_rec, iface_lig).  Unguarded like the
    reference: at d2 == 0 the elec term clamps and vdw goes NaN through
    inf - inf, and both clamps propagate NaN."""
    elec = (p.ele_rec[None, :, None] * p.ele_lig[None, None, :]) / d2
    elec = torch.clamp(elec, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF)
    total_elec = torch.where(d2 <= C.ELEC_DIST_CUTOFF2, elec,
                             torch.zeros_like(elec)).sum(dim=(1, 2))
    vdw_energy = torch.sqrt(p.vdw_c_rec[None, :, None] * p.vdw_c_lig[None, None, :])
    vdw_radius = p.vdw_r_rec[None, :, None] + p.vdw_r_lig[None, None, :]
    p2 = vdw_radius * vdw_radius / d2
    p6 = p2 * p2 * p2
    k = torch.clamp(vdw_energy * (p6 * p6 - 2.0 * p6), max=C.VDW_CUTOFF)
    total_vdw = torch.where(d2 <= C.VDW_DIST_CUTOFF2, k,
                            torch.zeros_like(k)).sum(dim=(1, 2))
    raw = total_elec * (C.FACTOR / C.EPSILON) + total_vdw
    close = d2 <= C.INTERFACE_CUTOFF2
    return raw, close.any(dim=2).to(d2.dtype), close.any(dim=1).to(d2.dtype)


def batch_energy_parts(p: BatchScoringParams, t, q, a_rec, a_lig):
    """(raw (G,), iface_rec (G, Nr), iface_lig (G, Nl)) before the affine
    finish and the bias."""
    d2 = pair_d2(*batch_pose_coords(p, t, q, a_rec, a_lig))
    if p.method == "dfire":
        return dfire_parts(p, d2)
    return elec_vdw_parts(p, d2)


def batch_energy(p: BatchScoringParams, t, q, a_rec, a_lig,
                 moved=None, prev_scoring=None):
    """(G,) scores.  ``moved``/``prev_scoring`` are accepted for the
    energy_fn signature and ignored: recomputing an unmoved pose gives its
    stored score."""
    raw, ifr, ifl = batch_energy_parts(p, t, q, a_rec, a_lig)
    return bias(p, finalize_raw(p, raw), ifr, ifl)


def batch_energy_chunked(p: BatchScoringParams, t, q, a_rec, a_lig,
                         chunk: int, moved=None, prev_scoring=None):
    """:func:`batch_energy` over ``chunk`` poses at a time (all at once when
    ``chunk`` <= 0), bounding the (chunk, Nr, Nl) temporaries."""
    g = t.shape[0]
    if chunk <= 0 or chunk >= g:
        return batch_energy(p, t, q, a_rec, a_lig)
    return torch.cat([batch_energy(p, t[i:i + chunk], q[i:i + chunk],
                                   a_rec[i:i + chunk], a_lig[i:i + chunk])
                      for i in range(0, g, chunk)])
