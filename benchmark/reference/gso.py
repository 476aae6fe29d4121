"""LightDock's GSO step, plainly, in float64, tracking which glowworms it
can vouch for.

One step (LightDock's ``swarm.rs``, ``glowworm.rs``): every glowworm that
moved in the last step is scored again (the others keep their score); its
luciferin becomes 0.5 l + 0.4 score; j is a neighbour of i when l_i < l_j
and |t_i - t_j| < vision_i; i draws u from the stream and takes the first
neighbour whose running sum of (l_j - l_i) / sum reaches u (the last one
if none does); it moves 0.5 A towards that neighbour's translation, slerps
its rotation halfway, and moves its ANM coefficients 0.5 towards the
neighbour's; its vision becomes vision + 0.08 (5 - neighbours), within
[0, 5].

A program in float32 rounds differently, so a decision whose two sides lie
within the rounding of the inputs (two luciferins, a distance and a vision
range, a draw and a running sum, a quaternion dot near 0) may go either
way there.  :func:`follow` marks a glowworm whose decisions were so close,
or that chose a glowworm so marked, as not followed.  A marked glowworm
may move otherwise in the program and change the choices of others later,
which this does not track: a program's followed glowworms agree with this
but for such knock-on changes, which the checks count as a share.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

RHO, GAMMA, BETA = 0.5, 0.4, 0.08
MAX_VISION, MAX_NEIGHBOURS = 5.0, 5
STEP_T = STEP_Q = STEP_A = 0.5
LINEAR = 0.9995


class State(NamedTuple):
    """A swarm after a step: float64 arrays, leading axis G."""

    t: np.ndarray          # (G, 3)
    q: np.ndarray          # (G, 4)
    anm: np.ndarray        # (G, K) receptor then ligand coefficients
    luciferin: np.ndarray  # (G,)
    vision: np.ndarray     # (G,)
    score: np.ndarray      # (G,)
    neighbours: np.ndarray  # (G,) int


def initial(poses: np.ndarray) -> State:
    """The state before step 1 of the poses (G, 7 + K) of a positions file:
    luciferin 5, vision 0.2, and every glowworm scored at step 1."""
    g = poses.shape[0]
    return State(poses[:, :3].copy(), poses[:, 3:7].copy(), poses[:, 7:].copy(),
                  np.full(g, 5.0), np.full(g, 0.2), np.zeros(g), np.ones(g, dtype=np.int64))


def normalize(q):
    return q / np.sqrt((q * q).sum(-1))[..., None]


def slerp(q1, q2, t):
    """LightDock's slerp: both normalised, q1 flipped where the dot is
    negative, a normalised lerp above 0.9995, else the sine form."""
    q1, q2 = normalize(q1), normalize(q2)
    dot = (q1 * q2).sum(-1)
    q1 = np.where((dot < 0)[:, None], -q1, q1)
    dot = np.abs(dot)
    omega = np.arccos(np.clip(dot, -1.0, 1.0))
    so = np.where(dot > LINEAR, 1.0, np.sin(omega))
    sph = (q1 * (np.sin((1 - t) * omega) / so)[:, None]
           + q2 * (np.sin(t * omega) / so)[:, None])
    return np.where((dot > LINEAR)[:, None], normalize(q1 + (q2 - q1) * t), sph)


class Band(NamedTuple):
    """How far a program's value may lie from this one's and still be the
    same answer: scores by ``rel`` of (1 + |score|) beyond their bracket,
    distances and vision ranges by ``dist`` A, running sums by ``cum``."""

    rel: float = 1e-5
    dist: float = 1e-4
    cum: float = 1e-6


def follow(state: State, draws: np.ndarray, scorer, anm_rec: int = 0, band: Band = Band()):
    """Run ``draws.shape[0]`` steps from ``state`` (draws (steps, G)),
    ``scorer(t, q, anm)`` giving (score, low, high) of poses, the first
    ``anm_rec`` ANM columns the receptor's.  Returns (the state after the
    steps, the (G,) bool of the glowworms followed, the luciferins (G, 2) and the
    scores (G, 2) a program may hold after them: a score is free within
    its bracket at every step).  A state's score is that of the pose before
    the step's move, as LightDock writes it."""
    t, q, anm = state.t.copy(), state.q.copy(), state.anm.copy()
    luc, vision, nn = state.luciferin.copy(), state.vision.copy(), state.neighbours.copy()
    slack = band.rel * (1.0 + np.abs(state.score))
    lo, hi, score = state.score - slack, state.score + slack, state.score.copy()
    luc_lo, luc_hi = luc - _width(luc, band), luc + _width(luc, band)
    ok = np.ones(len(t), dtype=bool)
    g = t.shape[0]
    for u in draws:
        moved = nn > 0
        if moved.any():
            s, s_lo, s_hi = scorer(t[moved], q[moved], anm[moved])
            slack = band.rel * (1.0 + np.abs(s))
            score[moved], lo[moved], hi[moved] = s, s_lo - slack, s_hi + slack
        luc = (1 - RHO) * luc + GAMMA * score
        luc_lo = (1 - RHO) * luc_lo + GAMMA * lo - _width(luc, band)
        luc_hi = (1 - RHO) * luc_hi + GAMMA * hi + _width(luc, band)

        known = ok.copy()
        dist = np.sqrt(((t[:, None, :] - t[None, :, :]) ** 2).sum(-1))
        brighter_sure = luc_hi[:, None] < luc_lo[None, :]
        brighter_maybe = luc_lo[:, None] < luc_hi[None, :]
        reach = vision[:, None]
        near_sure = dist < reach - band.dist
        near_maybe = dist < reach + band.dist
        off_diag = ~np.eye(g, dtype=bool)
        sure = brighter_sure & near_sure & off_diag
        maybe = brighter_maybe & near_maybe & off_diag
        ok &= ~(maybe & ~sure).any(axis=1)
        mask = (luc[:, None] < luc[None, :]) & (dist < reach) & off_diag
        count = mask.sum(axis=1)

        w = np.where(mask, luc[None, :] - luc[:, None], 0.0)
        total = w.sum(axis=1)
        cum = np.cumsum(w / np.where(total > 0, total, 1.0)[:, None], axis=1)
        err = band.cum + 2 * np.where(
            mask, (luc_hi - luc_lo)[None, :] + (luc_hi - luc_lo)[:, None], 0.0
        ).sum(axis=1) / np.where(total > 0, total, 1.0)
        ok &= ~(mask & (np.abs(cum - u[:, None]) <= err[:, None])).any(axis=1)
        reached = (cum >= u[:, None]) & mask
        last = g - 1 - np.argmax(mask[:, ::-1], axis=1)
        reached[np.arange(g), last] |= mask[np.arange(g), last]
        has = mask.any(axis=1)
        sel = np.where(has, np.argmax(reached, axis=1), np.arange(g))
        ok &= ~has | known[sel]

        delta = t[sel] - t
        norm = np.sqrt((delta * delta).sum(-1, keepdims=True))
        t_new = np.where(has[:, None], t + delta * (STEP_T / np.where(norm > 0, norm, 1.0)), t)
        dot = (normalize(q) * normalize(q[sel])).sum(-1)
        ok &= ~(has & (np.abs(dot) < 1e-6))
        q_new = np.where(has[:, None], slerp(q, q[sel], STEP_Q), q)
        anm = np.concatenate([_move(a, sel, has) for a in
                              (anm[:, :anm_rec], anm[:, anm_rec:])], axis=1)
        t, q = t_new, q_new
        vision = np.clip(vision + BETA * (MAX_NEIGHBOURS - count), 0.0, MAX_VISION)
        nn = count
    out = State(t, q, anm, luc, vision, score, nn)
    return out, ok, np.stack([luc_lo, luc_hi], axis=1), np.stack([lo, hi], axis=1)


def _move(a, sel, has):
    """ANM coefficients ``a`` moved 0.5 towards those of ``sel``."""
    if a.shape[1] == 0:
        return a
    d = a[sel] - a
    n = np.sqrt((d * d).sum(-1, keepdims=True))
    return np.where(has[:, None], a + d * (STEP_A / np.where(n > 0, n, 1.0)), a)


def _width(luc, band):
    return band.rel * (1.0 + np.abs(luc))
