"""The multi-swarm farm on one GPU: S swarms, one energy call a step.

Port of ``lightdock_tpu/parallel/farm.py`` (``SwarmFarmRunner``,
``run_swarm_farm``; its ``make_farm_step`` is ``engine.gso.swarms_step``)
for one device.  The reference
runs one OS process per swarm; here every step scores all S x G poses in
one flat energy call, so the pair kernel sees one large pose batch instead
of S small ones, and moves every swarm with one set of tensor ops
(``engine.gso.swarms_step``): the host launches a step stay those of one
swarm while the kernel's work grows S-fold.  The algorithm has no
cross-swarm interaction (reference src/swarm.rs:86-102), so each swarm's
trajectory is that of a single-swarm run from the same positions.

There is no device mesh: the swarm axis stays on one GPU, and receptor-atom
sharding waits for the port's multi-GPU path.
"""

from __future__ import annotations

import logging
import pathlib
import re
import time
from typing import List, Sequence

import numpy as np
import torch

from ..engine.gso import StepOutput, SwarmState, swarms_step
from ..engine.params import BatchScoringParams
from ..engine.runner import cuda_device, make_energy
from ..utils.output import read_state_sidecar
from .multihost import stack_swarm_states, swarm_randoms, write_swarm_outputs

log = logging.getLogger(__name__)


class SwarmFarmRunner:
    """Runs S swarms in lockstep on ``device``: parameters uploaded once,
    segments of steps, per-swarm snapshots with full-precision sidecars,
    resume.  Every energy mode of ``engine.runner.GsoTorchRunner`` is
    supported ('auto' is 'kernel'); ``energy_chunk`` > 0 caps the poses of
    one dense energy call, 0 scores all S x G at once (the kernel modes
    always do); ``cull`` False turns the kernel modes' box cull off
    (``engine.runner.make_energy``)."""

    def __init__(self, params: BatchScoringParams,
                 positions_list: Sequence[np.ndarray],
                 swarm_ids: Sequence[int], seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 dtype: torch.dtype = torch.float32, output_root=".",
                 energy_mode: str = "auto", energy_chunk: int = 0,
                 device="cuda", dq_bf16: bool = False, cull: bool = True):
        if len(positions_list) != len(swarm_ids):
            raise ValueError(f"{len(positions_list)} swarms for "
                             f"{len(swarm_ids)} swarm ids")
        self.device = cuda_device(device, "SwarmFarmRunner")
        self.swarm_ids = list(swarm_ids)
        self.n_swarms = len(positions_list)
        self.use_anm = use_anm
        self.output_root = output_root
        self.seed = seed
        self.dtype = dtype
        self.params, self.energy_fn = make_energy(
            params, energy_mode, self.device, dtype, energy_chunk, dq_bf16, cull)
        self.states = stack_swarm_states(positions_list, use_anm, anm_rec,
                                         anm_lig, dtype, self.device)
        self._initial_states = self.states
        self._start_step = 0

    # -- checkpoint/resume ---------------------------------------------------

    def reset(self) -> None:
        """Rewind every swarm to its initial state (timed repeats must
        restart the trajectory; see ``GsoTorchRunner.reset``)."""
        self._start_step = 0
        self.states = self._initial_states

    def resume_latest(self) -> int:
        """Resume from the newest full-precision sidecars.

        The swarms advance in lockstep, so the resume step is the minimum
        over swarms of each swarm's newest sidecar step: swarms that were
        further ahead are re-run from there, which reproduces them bit for
        bit (the engine is deterministic and the random stream positional).
        A swarm with no sidecar at all restarts the whole farm from step 0,
        with a warning, never silently.  Returns the resumed step (0 if
        none)."""
        root = pathlib.Path(self.output_root)
        newest = {}
        for sid in self.swarm_ids:
            steps = set()
            for p in (root / f"swarm_{sid}").glob("gso_*.out.npz"):
                m = re.match(r"gso_(\d+)\.out\.npz", p.name)
                if m:
                    steps.add(int(m.group(1)))
            newest[sid] = max(steps) if steps else 0
        if not any(newest.values()):
            if any((root / f"swarm_{sid}").exists() for sid in self.swarm_ids):
                log.warning(
                    "resume requested but no state sidecars found under %s: "
                    "restarting all %d swarms from step 0", root, self.n_swarms)
            return 0
        step = min(newest.values())
        if step == 0:
            log.warning(
                "resume: swarm(s) %s have no sidecars; restarting ALL "
                "swarms from step 0 (others had snapshots up to step %d)",
                [sid for sid, n in newest.items() if n == 0],
                max(newest.values()))
            return 0
        behind = [sid for sid, n in newest.items() if n > step]
        if behind:
            log.warning(
                "resume: lockstep farm resumes at step %d (the minimum of "
                "the newest per-swarm snapshots); swarm(s) %s were ahead "
                "and will be re-run deterministically", step, behind)
        per_swarm = []
        for sid in self.swarm_ids:
            _, arrays = read_state_sidecar(root / f"swarm_{sid}" / f"gso_{step}.out")
            per_swarm.append([torch.as_tensor(arrays[k], device=self.device)
                              for k in SwarmState._fields])
        self.states = SwarmState(*(torch.stack(xs) for xs in zip(*per_swarm)))
        self._start_step = step
        return step

    # -- execution -----------------------------------------------------------

    def run_segmented(self, steps: int, segment: int = 10, metrics=None):
        """Run every swarm to ``steps`` in segments of ``segment`` steps,
        writing each segment's snapshots (when ``output_root`` is not None)
        as it ends; ``metrics`` (``utils.metrics.RunMetrics``) gets each
        segment's poses (all swarms') and seconds, the device synchronized
        before the clock is read.  Returns (states, the last segment's
        StepOutput with fields (steps, S, ...))."""
        if self._start_step >= steps:
            return self.states, None
        g = self.states.t.shape[1]
        randoms = torch.as_tensor(
            swarm_randoms(self.seed, steps, self.n_swarms, g,
                          start_step=self._start_step),
            dtype=self.dtype, device=self.device)
        base = self._start_step
        outs = None
        while self._start_step < steps:
            start = self._start_step
            target = min(start + segment, steps)
            t0 = time.perf_counter()
            seg = []
            for i in range(start, target):
                self.states, out = swarms_step(self.params, self.states,
                                               randoms[i - base], self.energy_fn)
                seg.append(out)
            outs = StepOutput(*(torch.stack(f) for f in zip(*seg)))
            if self.output_root is not None:
                write_swarm_outputs(outs, self.swarm_ids, self.use_anm, target,
                                    self.output_root, start_step=start,
                                    sidecars=True)
            self._start_step = target
            if metrics is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                metrics.segment(start, target, (target - start) * g * self.n_swarms,
                                time.perf_counter() - t0)
        return self.states, outs


def run_swarm_farm(params: BatchScoringParams,
                   positions_list: Sequence[np.ndarray], swarm_ids: List[int],
                   seed: int, steps: int, use_anm: bool, anm_rec: int,
                   anm_lig: int, dtype: torch.dtype, output_root=".",
                   energy_chunk: int = 0, energy_mode: str = "dense",
                   n_atom_shards: int = 1, segment: int = 10,
                   metrics=None, resume: bool = False, device="cuda") -> None:
    """Run S swarms to ``steps`` and write their outputs, resuming from
    their sidecars with ``resume``; ``metrics`` as in
    ``SwarmFarmRunner.run_segmented``.  ``n_atom_shards`` > 1 (receptor
    atoms sharded over devices) needs the multi-GPU path and raises."""
    if n_atom_shards > 1:
        raise NotImplementedError(
            f"n_atom_shards={n_atom_shards}: receptor-atom sharding needs the "
            "multi-GPU path, which the port does not have yet; the farm runs "
            "on one GPU")
    runner = SwarmFarmRunner(params, positions_list, swarm_ids, seed, use_anm,
                             anm_rec, anm_lig, dtype=dtype,
                             output_root=output_root, energy_mode=energy_mode,
                             energy_chunk=energy_chunk, device=device)
    if resume:
        resumed = runner.resume_latest()
        if resumed:
            log.info("resumed %d swarms at step %d", runner.n_swarms, resumed)
    runner.run_segmented(steps, segment=segment, metrics=metrics)
