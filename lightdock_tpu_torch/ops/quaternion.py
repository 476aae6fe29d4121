"""Quaternion algebra on torch tensors (last axis is (w, x, y, z)).

Port of ``lightdock_tpu/ops/quaternion.py``: the same arithmetic, in the
same order, written natively for torch (the reference's ``xp``-generic
source passes Python scalars to ``xp.maximum``/``xp.where``, which torch
does not take).  Every function broadcasts over leading batch axes.

:func:`slerp_host` is a NumPy copy of the original ``slerp`` for the host
engine's moves (``engine.gso_host``): torch's CPU ``arccos`` and ``sin``
part from NumPy's in the last ulp on some quaternion pairs, and the host
engine must move its glowworms bit for bit as the original does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import LINEAR_THRESHOLD


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((q * q).sum(dim=-1))
    return q / n[..., None]


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternion tensors (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qinverse(q: torch.Tensor) -> torch.Tensor:
    conj = torch.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], dim=-1)
    return conj / (q * q).sum(dim=-1)[..., None]


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vectors ``v`` (..., 3) rotated by ``q`` (..., 4) in the reference's
    double Hamilton product form ``q * (0, v) * q^-1``, the division by
    |q|^2 included (the host scorer's transform)."""
    vq = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return qmul(qmul(q, vq), qinverse(q))[..., 1:]


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) of ``q``, including the 1/|q|^2
    factor of the reference's ``q v q^-1`` form."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n2 = w * w + x * x + y * y + z * z
    s = 1.0 / n2
    m = torch.stack(
        [
            torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         w * w - x * x - y * y + z * z], dim=-1),
        ],
        dim=-2,
    )
    return m * s[..., None, None]


def slerp(q1: torch.Tensor, q2: torch.Tensor, t: float) -> torch.Tensor:
    """Spherical linear interpolation with the reference's semantics:
    normalise both, flip q1 when the dot is negative, normalised lerp
    above LINEAR_THRESHOLD, else the sin-ratio form (clamped min then
    max).  Branch-free."""
    q1 = qnormalize(q1)
    q2 = qnormalize(q2)
    d = (q1 * q2).sum(dim=-1)
    flip = d < 0.0
    q1 = torch.where(flip[..., None], -q1, q1)
    d = torch.where(flip, -d, d)

    lin = qnormalize(q1 + (q2 - q1) * t)

    dc = torch.clamp(torch.clamp(d, max=1.0), min=-1.0)
    omega = torch.arccos(dc)
    so = torch.sin(omega)
    linear = d > LINEAR_THRESHOLD
    # Guard the (unused) spherical values in the linear regime against 0/0.
    so_safe = torch.where(linear, torch.ones_like(so), so)
    c1 = torch.sin((1.0 - t) * omega) / so_safe
    c2 = torch.sin(t * omega) / so_safe
    sph = q1 * c1[..., None] + q2 * c2[..., None]
    return torch.where(linear[..., None], lin, sph)


def qnormalize_host(q: np.ndarray) -> np.ndarray:
    n = np.sqrt((q * q).sum(axis=-1))
    return q / n[..., None]


def slerp_host(q1: np.ndarray, q2: np.ndarray, t: float) -> np.ndarray:
    """NumPy copy of the original ``slerp`` (see the module docstring),
    the same operations in the same order."""
    q1 = qnormalize_host(q1)
    q2 = qnormalize_host(q2)
    d = (q1 * q2).sum(axis=-1)
    flip = d < 0.0
    q1 = np.where(flip[..., None], -q1, q1)
    d = np.where(flip, -d, d)

    lin = qnormalize_host(q1 + (q2 - q1) * t)

    dc = np.maximum(np.minimum(d, 1.0), -1.0)
    omega = np.arccos(dc)
    so = np.sin(omega)
    # Guard the (unused) spherical values in the linear regime against 0/0.
    so_safe = np.where(d > LINEAR_THRESHOLD, 1.0, so)
    c1 = np.sin((1.0 - t) * omega) / so_safe
    c2 = np.sin(t * omega) / so_safe
    sph = q1 * c1[..., None] + q2 * c2[..., None]
    return np.where((d > LINEAR_THRESHOLD)[..., None], lin, sph)
