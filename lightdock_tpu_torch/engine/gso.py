"""Batched GSO step on torch tensors.

Port of ``lightdock_tpu/engine/gso_jax.py`` ``SwarmState``,
``StepOutput``, ``init_state``, ``gso_step`` and ``run_swarm``: scoring,
luciferin, the (G, G) neighbour search, the masked-cumsum roulette with
its float-safety net, the moves toward the pre-move snapshot, and the
vision update.  ``run_swarm`` is a Python loop over steps.

Scoring and movement are split (:func:`gso_energy`, :func:`gso_move`) so
that S stacked swarms (leading axis S on every state field) take one step
with one energy call over all S x G poses and one set of tensor ops for
all the moves (:func:`swarms_step`, port of
``lightdock_tpu/parallel/farm.py`` ``make_farm_step``):
``torch.func.vmap`` of :func:`gso_move` over the swarm axis, where JAX ran
``jax.vmap``; and so that ``engine.runner`` captures each part in a CUDA
graph of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..ops import quaternion as qt
from ..utils import metrics
from ..utils.positions import split_positions


class SwarmState(NamedTuple):
    """Per-glowworm state, leading axis G."""

    t: torch.Tensor          # (G, 3) translations
    q: torch.Tensor          # (G, 4) rotations (w, x, y, z)
    a_rec: torch.Tensor      # (G, Ka_r) receptor ANM coefficients
    a_lig: torch.Tensor      # (G, Ka_l) ligand ANM coefficients
    luciferin: torch.Tensor  # (G,)
    vision: torch.Tensor     # (G,)
    scoring: torch.Tensor    # (G,)
    num_neighbors: torch.Tensor  # (G,) int32


class StepOutput(NamedTuple):
    """Per-step observables, stacked over steps by ``run_swarm``."""

    t: torch.Tensor
    q: torch.Tensor
    a_rec: torch.Tensor
    a_lig: torch.Tensor
    luciferin: torch.Tensor
    vision: torch.Tensor
    scoring: torch.Tensor
    num_neighbors: torch.Tensor


def init_state(positions: np.ndarray, use_anm: bool, anm_rec: int,
               anm_lig: int, dtype: torch.dtype, device) -> SwarmState:
    t, q, ar, al = split_positions(np.asarray(positions, dtype=np.float64),
                                   use_anm, anm_rec, anm_lig)
    g = t.shape[0]

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return SwarmState(
        t=tensor(t), q=tensor(q), a_rec=tensor(ar), a_lig=tensor(al),
        luciferin=torch.full((g,), C.GSO_INITIAL_LUCIFERIN, dtype=dtype,
                             device=device),
        vision=torch.full((g,), C.GSO_INITIAL_VISION_RANGE, dtype=dtype,
                          device=device),
        scoring=torch.zeros(g, dtype=dtype, device=device),
        # 1, not 0: num_neighbors > 0 is the "moved last phase" rescoring
        # gate, and every pose scores on step one.
        num_neighbors=torch.ones(g, dtype=torch.int32, device=device),
    )


def gso_step(params, state: SwarmState, randoms: torch.Tensor, energy_fn):
    """One GSO iteration; returns (new_state, StepOutput).  ``energy_fn``
    has the signature of ``energy_kernel.make_kernel_energy_fn``'s result
    (the dense ``energy_dense.batch_energy`` also fits).  Spans ``energy``
    and ``move``; the counter ``poses_scored`` adds the poses the energy
    is asked to score, as the mask itself (``utils.metrics.count``)."""
    with metrics.span("energy"):
        scoring = gso_energy(params, state, energy_fn)
    with metrics.span("move"):
        return gso_move(params, state, scoring.to(state.t.dtype), randoms)


def gso_energy(params, state: SwarmState, energy_fn):
    """The first part of a GSO iteration, the step's (G,) scores: the
    glowworms that moved last phase are scored, the others keep their
    score.  Counts ``poses_scored`` while a recorder is active."""
    moved_prev = state.num_neighbors > 0
    if metrics.recording():
        metrics.count("poses_scored", moved_prev)
    return energy_fn(params, state.t, state.q, state.a_rec, state.a_lig,
                     moved=moved_prev, prev_scoring=state.scoring)


def gso_move(params, state: SwarmState, scoring: torch.Tensor,
             randoms: torch.Tensor):
    """The rest of a GSO iteration once the step's scores are known:
    luciferin, neighbours, roulette, moves and vision.  Returns
    (new_state, StepOutput).  Only ``params.use_anm`` is read."""
    g = state.t.shape[0]
    dtype = state.t.dtype
    dev = state.t.device
    luciferin = (1.0 - C.GSO_RHO) * state.luciferin + C.GSO_GAMMA * scoring

    # 2. Neighbours: j of i iff L_i < L_j and |t_i - t_j| < vision_i.
    diff = state.t[:, None, :] - state.t[None, :, :]
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    mask = (luciferin[:, None] < luciferin[None, :]) & (dist < state.vision[:, None])
    mask = mask & ~torch.eye(g, dtype=torch.bool, device=dev)
    num_neighbors = mask.sum(dim=1).to(torch.int32)
    has_nb = mask.any(dim=1)

    # 3. Roulette: first neighbour whose cumulative probability reaches the
    #    draw; each weight is normalised before accumulating.
    w = torch.where(mask, luciferin[None, :] - luciferin[:, None],
                    torch.zeros((), dtype=dtype, device=dev))
    total = torch.cumsum(w, dim=1)[:, -1]
    total_safe = torch.where(total > 0, total, torch.ones_like(total))
    cump = torch.cumsum(w / total_safe[:, None], dim=1)
    ge = (cump >= randoms.to(dtype)[:, None]) & mask
    # Float-safety net: the last neighbour is always selectable.
    col = torch.arange(g, device=dev)[None, :]
    last_nb = (g - 1) - torch.argmax(mask.flip(1).to(torch.int32), dim=1)
    ge = ge | (mask & (col == last_nb[:, None]))
    sel = torch.argmax(ge.to(torch.int32), dim=1)
    sel = torch.where(has_nb, sel, torch.arange(g, device=dev))

    # 4. Moves toward the pre-move snapshot.
    mo = has_nb[:, None]
    delta = state.t[sel] - state.t
    norm = torch.sqrt((delta * delta).sum(dim=-1, keepdim=True))
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    t_new = torch.where(mo, state.t + delta * (C.DEFAULT_TRANSLATION_STEP / norm),
                        state.t)
    q_new = torch.where(mo, qt.slerp(state.q, state.q[sel],
                                     C.DEFAULT_ROTATION_STEP), state.q)

    def move_anm(a):
        if a.shape[1] == 0:
            return a
        d = a[sel] - a
        n = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
        n = torch.where(n > 0, n, torch.ones_like(n))
        return torch.where(mo, a + d * (C.DEFAULT_NMODES_STEP / n), a)

    a_rec = move_anm(state.a_rec) if params.use_anm else state.a_rec
    a_lig = move_anm(state.a_lig) if params.use_anm else state.a_lig

    # 5. Vision range.
    vision = torch.clamp(
        state.vision + C.GSO_BETA * (C.GSO_MAX_NEIGHBORS - num_neighbors.to(dtype)),
        min=0.0, max=C.GSO_MAX_VISION_RANGE)

    fields = (t_new, q_new, a_rec, a_lig, luciferin, vision, scoring,
              num_neighbors)
    return SwarmState(*fields), StepOutput(*fields)


def swarms_step(params, states: SwarmState, randoms: torch.Tensor, energy_fn):
    """One GSO iteration of S stacked swarms (every field and ``randoms``
    lead with S): the S x G poses scored by one ``energy_fn`` call, then
    every swarm moved by :func:`gso_move` vmapped over S.  No Python loop
    over swarms: the host launches stay those of one swarm.  Spans and
    counter as :func:`gso_step`'s."""
    s, g = states.t.shape[:2]
    with metrics.span("energy"):
        moved_prev = (states.num_neighbors > 0).reshape(s * g)
        if metrics.recording():
            metrics.count("poses_scored", moved_prev)
        scores = energy_fn(params, states.t.reshape(s * g, 3),
                           states.q.reshape(s * g, 4),
                           states.a_rec.reshape(s * g, -1),
                           states.a_lig.reshape(s * g, -1), moved=moved_prev,
                           prev_scoring=states.scoring.reshape(s * g))
    with metrics.span("move"):
        move = torch.func.vmap(lambda st, sc, r: gso_move(params, st, sc, r))
        return move(states, scores.to(states.t.dtype).reshape(s, g), randoms)


def run_swarm(params, state: SwarmState, randoms: torch.Tensor, energy_fn):
    """``randoms.shape[0]`` steps; returns (final_state, StepOutput with
    each field stacked over steps)."""
    outs = []
    for r in randoms:
        state, out = gso_step(params, state, r, energy_fn)
        outs.append(out)
    return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))
