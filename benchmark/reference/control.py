"""The control: the reference put in the program's place, one precision down.

The configurations state float32, so the control runs the whole GSO job
(scores and moves, the ANM coefficients' too) in bfloat16 on the same
inputs and writes the same ``swarm_<s>/gso_<step>.out`` snapshots the
program writes.  The checks have to find it wrong.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from . import gsofile, gso as ref_gso
from .rng import uniforms


def _slerp(q1, q2, t):
    def norm(q):
        return q / torch.sqrt((q * q).sum(-1, keepdim=True))

    q1, q2 = norm(q1), norm(q2)
    dot = (q1 * q2).sum(-1)
    q1 = torch.where((dot < 0)[:, None], -q1, q1)
    dot = dot.abs()
    omega = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    linear = dot > ref_gso.LINEAR
    so = torch.where(linear, torch.ones_like(omega), torch.sin(omega))
    sph = q1 * (torch.sin((1 - t) * omega) / so)[:, None] + q2 * (torch.sin(t * omega) / so)[:, None]
    return torch.where(linear[:, None], norm(q1 + (q2 - q1) * t), sph)


def _move(a, sel, has):
    """ANM coefficients ``a`` moved 0.5 towards those of ``sel``."""
    if a.shape[1] == 0:
        return a
    d = a[sel] - a
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    return torch.where(has[:, None], a + d * (ref_gso.STEP_A / torch.where(
        n > 0, n, torch.ones_like(n))), a)


def run_swarm(poses: np.ndarray, seed: int, steps: int, scorer, out_dir,
              dtype=torch.bfloat16, anm_rec: int = 0) -> None:
    """One swarm from ``poses`` (G, 7 + K) for ``steps`` steps at ``dtype``,
    scored by ``scorer`` (a reference scorer at ``dtype``), the first
    ``anm_rec`` of the K ANM coefficients the receptor's, its snapshots at
    step 1 and every tenth written under ``out_dir``."""
    dev = scorer.device
    g = poses.shape[0]
    draws = torch.as_tensor(uniforms(seed, steps * g).reshape(steps, g), dtype=dtype, device=dev)
    t = torch.as_tensor(poses[:, :3], dtype=dtype, device=dev)
    q = torch.as_tensor(poses[:, 3:7], dtype=dtype, device=dev)
    anm = torch.as_tensor(poses[:, 7:], dtype=dtype, device=dev)
    luc = torch.full((g,), 5.0, dtype=dtype, device=dev)
    vision = torch.full((g,), 0.2, dtype=dtype, device=dev)
    score = torch.zeros(g, dtype=dtype, device=dev)
    moved = torch.ones(g, dtype=torch.bool, device=dev)
    eye = torch.eye(g, dtype=torch.bool, device=dev)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for step in range(1, steps + 1):
        if bool(moved.any()):
            s = scorer.score(*(x[moved].double().cpu().numpy() for x in (t, q, anm)))[0]
            score[moved] = torch.as_tensor(s, dtype=dtype, device=dev)
        luc = (1 - ref_gso.RHO) * luc + ref_gso.GAMMA * score
        dist = torch.sqrt(((t[:, None, :] - t[None, :, :]) ** 2).sum(-1))
        mask = (luc[:, None] < luc[None, :]) & (dist < vision[:, None]) & ~eye
        count = mask.sum(1)
        w = torch.where(mask, luc[None, :] - luc[:, None], torch.zeros((), dtype=dtype, device=dev))
        total = w.sum(1)
        cum = torch.cumsum(w / torch.where(total > 0, total, torch.ones_like(total))[:, None], 1)
        reached = (cum >= draws[step - 1][:, None]) & mask
        last = g - 1 - torch.argmax(mask.flip(1).to(torch.int32), 1)
        reached[torch.arange(g, device=dev), last] |= mask[torch.arange(g, device=dev), last]
        has = mask.any(1)
        sel = torch.where(has, torch.argmax(reached.to(torch.int32), 1), torch.arange(g, device=dev))
        delta = t[sel] - t
        norm = torch.sqrt((delta * delta).sum(-1, keepdim=True))
        t = torch.where(has[:, None], t + delta * (ref_gso.STEP_T / torch.where(
            norm > 0, norm, torch.ones_like(norm))), t)
        q = torch.where(has[:, None], _slerp(q, q[sel], ref_gso.STEP_Q), q)
        anm = torch.cat([_move(a, sel, has) for a in (anm[:, :anm_rec], anm[:, anm_rec:])], 1)
        vision = torch.clamp(vision + ref_gso.BETA * (ref_gso.MAX_NEIGHBOURS - count).to(dtype),
                             0.0, ref_gso.MAX_VISION)
        moved = count > 0
        if step == 1 or step % 10 == 0:
            cols = [x.double().cpu().numpy() for x in (t, q, anm, luc, count, vision, score)]
            gsofile.write(out_dir / f"gso_{step}.out", np.concatenate(cols[:3], axis=1),
                          *cols[3:])
