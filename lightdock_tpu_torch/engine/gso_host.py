"""Host parity GSO engine: float64 moves in the reference's order.

Port of ``lightdock_tpu/engine/gso_host.py``.  It follows the reference's
trajectories (reference src/lib.rs:46-58, src/swarm.rs:66-126,
src/glowworm.rs:61-190) as closely as IEEE arithmetic allows: the state
and the moves stay on the host in NumPy float64, with the bit-exact
rand-0.7 stream (one draw a glowworm, in id order), the probability sum
and the roulette as sequential Python float loops, and each worm's move in
the reference's operation order, so that the moves are the original's bit
for bit.  Only the energies of the worms that moved go to ``device`` (the
CUDA card unless the caller asks for the CPU), ``energy_chunk`` poses a
call, through the dense float64 energy (``engine.energy_dense``); their
pair sums run in torch's order, which the 8-decimal snapshots rarely show.
"""

from __future__ import annotations

import math
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops.quaternion import slerp_host
from ..utils.output import write_gso_output
from ..utils.positions import split_positions
from ..utils.rng import ReferenceRng
from .energy_dense import batch_energy
from .params import BatchScoringParams, torch_params


class GsoHostEngine:
    def __init__(self, params: BatchScoringParams, positions, seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 output_directory: Optional[str] = None,
                 energy_chunk: int = 32, device="cuda"):
        from .runner import cuda_device

        self.params = params
        self.device = cuda_device(device, "GsoHostEngine")
        self.tparams = torch_params(params, self.device, torch.float64)
        self.rng = ReferenceRng(seed)
        self.output_directory = output_directory
        self.energy_chunk = energy_chunk

        t, q, a_rec, a_lig = split_positions(np.asarray(positions, dtype=np.float64),
                                             use_anm, anm_rec, anm_lig)
        g = t.shape[0]
        self.t = t
        self.q = q
        self.a_rec = a_rec
        self.a_lig = a_lig
        self.use_anm = use_anm
        self.luciferin = np.full(g, C.GSO_INITIAL_LUCIFERIN)
        self.vision = np.full(g, C.GSO_INITIAL_VISION_RANGE)
        self.scoring = np.zeros(g)
        self.moved = np.zeros(g, dtype=bool)
        self.num_neighbors = np.zeros(g, dtype=np.int64)
        self.step = 0

    @property
    def num_glowworms(self) -> int:
        return self.t.shape[0]

    # -- scoring -----------------------------------------------------------
    def _recompute_energies(self) -> None:
        """Score the worms that moved (every worm at step 0) on ``device``,
        ``energy_chunk`` at a time in id order.

        The reference's lazy rescoring rule (src/glowworm.rs:61-69):
        unmoved worms keep their stored score.
        """
        need = self.moved | (self.step == 0)
        idx = np.nonzero(need)[0]
        for start in range(0, idx.size, self.energy_chunk):
            sl = idx[start:start + self.energy_chunk]
            poses = [torch.as_tensor(x[sl], device=self.device)
                     for x in (self.t, self.q, self.a_rec, self.a_lig)]
            self.scoring[sl] = batch_energy(self.tparams, *poses).cpu().numpy()

    def update_luciferin(self) -> None:
        self._recompute_energies()
        self.luciferin = (1.0 - C.GSO_RHO) * self.luciferin + C.GSO_GAMMA * self.scoring
        self.step += 1

    # -- movement ----------------------------------------------------------
    def movement_phase(self) -> None:
        g = self.num_glowworms
        # Snapshot poses (reference src/swarm.rs:74-83): every move targets
        # the pre-move pose of the selected neighbor.
        t0, q0 = self.t.copy(), self.q.copy()
        ar0, al0 = self.a_rec.copy(), self.a_lig.copy()

        # Neighbor search (src/swarm.rs:86-102): j is a neighbor of i iff
        # L_i < L_j and ||t_i - t_j|| < vision_i.
        diff = t0[:, None, :] - t0[None, :, :]
        dist = np.sqrt((diff * diff).sum(axis=-1))
        lum = self.luciferin
        mask = (lum[:, None] < lum[None, :]) & (dist < self.vision[:, None])
        np.fill_diagonal(mask, False)
        self.num_neighbors = mask.sum(axis=1)

        randoms = self.rng.gen(g)  # one draw per glowworm, id order (swarm.rs:118)

        for i in range(g):
            nbrs = np.nonzero(mask[i])[0]
            if nbrs.size == 0:
                self.moved[i] = False
                continue
            # Probability vector + roulette selection in the reference's
            # exact sequential arithmetic (src/glowworm.rs:98-126).
            diffs = [lum[j] - lum[i] for j in nbrs]
            total = 0.0
            for dd in diffs:
                total += dd
            probs = [dd / total for dd in diffs]
            r = randoms[i]
            acc = 0.0
            k = 0
            while acc < r:
                acc += probs[k]
                k += 1
            j = int(nbrs[k - 1])

            self.moved[i] = True
            # Translation (src/glowworm.rs:138-153)
            delta = t0[j] - self.t[i]
            norm = math.sqrt(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2])
            coef = C.DEFAULT_TRANSLATION_STEP / norm
            self.t[i] = self.t[i] + delta * coef
            # Rotation (src/glowworm.rs:156)
            self.q[i] = slerp_host(self.q[i], q0[j], C.DEFAULT_ROTATION_STEP)
            # ANM (src/glowworm.rs:159-188), NumPy's sum of squares
            if self.use_anm and self.a_rec.shape[1] > 0:
                d = ar0[j] - self.a_rec[i]
                n = math.sqrt(float((d * d).sum()))
                self.a_rec[i] = self.a_rec[i] + d * (C.DEFAULT_NMODES_STEP / n)
            if self.use_anm and self.a_lig.shape[1] > 0:
                d = al0[j] - self.a_lig[i]
                n = math.sqrt(float((d * d).sum()))
                self.a_lig[i] = self.a_lig[i] + d * (C.DEFAULT_NMODES_STEP / n)

        # Vision-range update (src/glowworm.rs:91-96)
        self.vision = np.minimum(
            C.GSO_MAX_VISION_RANGE,
            np.maximum(0.0, self.vision + C.GSO_BETA
                       * (C.GSO_MAX_NEIGHBORS - self.num_neighbors.astype(np.float64))))

    # -- run ---------------------------------------------------------------
    def poses(self) -> np.ndarray:
        cols = [self.t, self.q]
        if self.use_anm and self.a_rec.shape[1] > 0:
            cols.append(self.a_rec)
        if self.use_anm and self.a_lig.shape[1] > 0:
            cols.append(self.a_lig)
        return np.concatenate(cols, axis=1)

    def save(self, step: int) -> None:
        """``gso_{step}.out`` through the native writer."""
        if self.output_directory is None:
            return
        path = pathlib.Path(self.output_directory) / f"gso_{step}.out"
        write_gso_output(path, self.poses(), self.luciferin,
                         self.num_neighbors, self.vision, self.scoring)

    def run(self, steps: int, on_step: Optional[Callable] = None) -> None:
        """Reference cadence: a snapshot at step 1 and every 10th step
        (src/lib.rs:46-58)."""
        for step in range(1, steps + 1):
            self.update_luciferin()
            self.movement_phase()
            if step % 10 == 0 or step == 1:
                self.save(step)
            if on_step is not None:
                on_step(self, step)
