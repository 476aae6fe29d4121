"""The multi-swarm farm: S swarms, one energy call a step on each GPU.

Port of ``lightdock_tpu/parallel/farm.py`` (``SwarmFarmRunner``,
``run_swarm_farm``; its ``make_farm_step`` is ``engine.gso.swarms_step``).
The reference runs one OS process per swarm; here every step scores all
S x G poses of a device in one flat energy call, so the pair kernel sees
one large pose batch instead of S small ones, and moves every swarm with
one set of tensor ops (``engine.gso.swarms_step``): the host launches a
step stay those of one swarm while the kernel's work grows S-fold.  The
algorithm has no cross-swarm interaction (reference src/swarm.rs:86-102),
so each swarm's trajectory is that of a single-swarm run from the same
positions.

On a mesh of ranks (``parallel.mesh``) each rank runs its own block of
swarms (``Mesh.swarm_block``: the last blocks may hold a swarm fewer,
where JAX pads with replays of swarm 0) with no traffic during
optimization, and writes only those swarms.  ``run_swarm_farm`` with
``n_atom_shards`` > 1 also splits the receptor atoms over the mesh's atoms
axis (``parallel.sharded``).
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
from ..engine.runner import cuda_device, make_energy, resolve_energy_mode
from ..utils.metrics import end as end_span
from ..utils.output import read_state_sidecar
from .mesh import make_mesh
from .multihost import (barrier, stack_swarm_states, swarm_randoms,
                        write_swarm_outputs)

log = logging.getLogger(__name__)


def largest_block(n_swarms: int, mesh) -> int:
    """The most swarms a rank of ``mesh`` runs (all of them without one):
    every rank resolves 'auto' for the same poses a call, so all run one
    mode."""
    n_ranks = 1 if mesh is None else mesh.n_swarm
    return -(-n_swarms // n_ranks)


class SwarmFarmRunner:
    """Runs S swarms in lockstep on ``device``: parameters uploaded once,
    segments of steps, per-swarm snapshots with full-precision sidecars,
    resume.  Every energy mode of ``engine.runner.GsoTorchRunner`` is
    supported ('auto' is ``engine.runner.pick_energy_mode``'s mode for
    the poses of one call, G times the largest rank's swarms;
    ``energy_mode`` holds the mode it runs); ``energy_chunk`` > 0 caps the
    poses of one dense energy call, 0 scores all S x G at once (the
    kernel modes always do); ``cull`` False turns the kernel
    modes' box cull off (``engine.runner.make_energy``).

    With a ``mesh`` (``parallel.mesh.make_mesh`` with one rank on the
    atoms axis) this rank runs and writes its own block of the swarms, on
    ``mesh.device`` (``device`` is then not read); ``positions_list`` and
    ``swarm_ids`` still name every swarm, ``states`` holds the block."""

    def __init__(self, params: BatchScoringParams,
                 positions_list: Sequence[np.ndarray],
                 swarm_ids: Sequence[int], seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 dtype: torch.dtype = torch.float32, output_root=".",
                 energy_mode: str = "auto", energy_chunk: int = 0,
                 device="cuda", dq_bf16: bool = False, cull: bool = True,
                 mesh=None):
        if len(positions_list) != len(swarm_ids):
            raise ValueError(f"{len(positions_list)} swarms for "
                             f"{len(swarm_ids)} swarm ids")
        if mesh is not None and mesh.n_atoms != 1:
            raise ValueError("SwarmFarmRunner splits swarms only; receptor atoms "
                             "split through run_swarm_farm(n_atom_shards=...)")
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else cuda_device(device, "SwarmFarmRunner"))
        self.swarm_ids = list(swarm_ids)
        self.n_swarms = len(positions_list)
        self._block = (range(self.n_swarms) if mesh is None
                       else mesh.swarm_block(self.n_swarms))
        self.use_anm = use_anm
        self.output_root = output_root
        self.seed = seed
        self.dtype = dtype
        self.energy_mode = resolve_energy_mode(
            params, energy_mode, self.device,
            largest_block(self.n_swarms, mesh) * positions_list[0].shape[0],
            "SwarmFarmRunner")
        self.params, self.energy_fn = make_energy(
            params, self.energy_mode, self.device, dtype, energy_chunk, dq_bf16,
            cull)
        self.states = stack_swarm_states([positions_list[i] for i in self._block],
                                         use_anm, anm_rec, anm_lig, dtype,
                                         self.device)
        self._initial_states = self.states
        self._start_step = 0

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            barrier(self.device)

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
        with a warning, never silently.  On a mesh every rank reads every
        swarm's sidecars (one shared directory), so all resume at the same
        step, and none goes on before all have read.  Returns the resumed
        step (0 if none)."""
        step = self._resume_step()
        if step:
            root = pathlib.Path(self.output_root)
            per_swarm = []
            for i in self._block:
                _, arrays = read_state_sidecar(
                    root / f"swarm_{self.swarm_ids[i]}" / f"gso_{step}.out")
                per_swarm.append([torch.as_tensor(arrays[k], device=self.device)
                                  for k in SwarmState._fields])
            self.states = SwarmState(*(torch.stack(xs) for xs in zip(*per_swarm)))
            self._start_step = step
        self._barrier()
        return step

    def _resume_step(self) -> int:
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
        return step

    # -- execution -----------------------------------------------------------

    def run_segmented(self, steps: int, segment: int = 10, metrics=None):
        """Run every swarm to ``steps`` in segments of ``segment`` steps,
        writing each segment's snapshots (when ``output_root`` is not None)
        as it ends; ``metrics`` (``utils.metrics.RunMetrics``) gets each
        segment's poses (every swarm's, on a mesh too) and seconds, read
        after the device is synchronized and, on a mesh, every rank has
        ended the segment (every rank passes ``metrics`` or none does).  On
        a mesh no rank returns before every rank has written its snapshots.
        The random stream ends the command line's ``runner_setup`` span.
        Returns (states, the last segment's StepOutput with fields (steps,
        S, ...), S this rank's swarms)."""
        if self._start_step >= steps:
            return self.states, None
        s_local, g = self.states.t.shape[:2]
        randoms = torch.as_tensor(
            swarm_randoms(self.seed, steps, s_local, g,
                          start_step=self._start_step),
            dtype=self.dtype, device=self.device)
        end_span("runner_setup")
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
                                    sidecars=True, mesh=self.mesh)
            self._start_step = target
            if metrics is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._barrier()
                metrics.segment(start, target, (target - start) * g * self.n_swarms,
                                time.perf_counter() - t0)
        # Every rank's snapshots are on disk before any rank goes on (a
        # resume reads them all).
        self._barrier()
        return self.states, outs


def run_swarm_farm(params: BatchScoringParams,
                   positions_list: Sequence[np.ndarray], swarm_ids: List[int],
                   seed: int, steps: int, use_anm: bool, anm_rec: int,
                   anm_lig: int, dtype: torch.dtype, output_root=".",
                   energy_chunk: int = 0, energy_mode: str = "dense",
                   n_atom_shards: int = 1, segment: int = 10,
                   metrics=None, resume: bool = False, device="cuda",
                   mesh=None) -> None:
    """Run S swarms to ``steps`` and write their outputs, resuming from
    their sidecars with ``resume``; ``metrics`` as in
    ``SwarmFarmRunner.run_segmented``.  The swarms split over the ranks of
    ``mesh``, by default ``parallel.mesh.make_mesh(n_atoms=n_atom_shards,
    device=device)`` over the world (one process: one rank).

    ``n_atom_shards`` > 1 also splits the receptor atoms over the mesh's
    atoms axis, as JAX's does: 'kernel' runs
    ``sharded.run_multi_swarm_2d_kernel`` (K1, K2 or K3 on each rank's
    receptor slice), 'dense' ``sharded.run_multi_swarm_2d``, 'auto'
    whichever ``engine.runner.pick_energy_mode`` picks for the whole
    receptor and the rank's poses (JAX's takes 'auto' as 'xla' there); 'kernel_v1' raises.
    That path, as JAX's, runs every step and then writes the snapshots,
    with no resume and no metrics."""
    if n_atom_shards > 1 and energy_mode not in ("auto", "kernel", "dense"):
        raise ValueError("atom sharding composes with the v2 kernels "
                         "(energy_mode='kernel') or the dense energy, not "
                         f"{energy_mode!r}")
    if mesh is None:
        mesh = make_mesh(n_atoms=n_atom_shards, device=device)
    if mesh.n_atoms != n_atom_shards:
        raise ValueError(f"n_atom_shards={n_atom_shards} on a mesh of "
                         f"{mesh.n_atoms} ranks on its atoms axis")
    if n_atom_shards > 1:
        from .sharded import run_multi_swarm_2d, run_multi_swarm_2d_kernel

        block = mesh.swarm_block(len(positions_list))
        states = stack_swarm_states([positions_list[i] for i in block], use_anm,
                                    anm_rec, anm_lig, dtype, mesh.device)
        randoms = torch.as_tensor(
            swarm_randoms(seed, steps, len(block), states.t.shape[1]),
            dtype=dtype, device=mesh.device)
        mode = resolve_energy_mode(
            params, energy_mode, mesh.device,
            largest_block(len(positions_list), mesh) * states.t.shape[1],
            "run_swarm_farm")
        run = run_multi_swarm_2d_kernel if mode == "kernel" else run_multi_swarm_2d
        _, outs = run(mesh, params, states, randoms)
        write_swarm_outputs(outs, swarm_ids, use_anm, steps, output_root,
                            sidecars=True, mesh=mesh)
        if mesh.size > 1:
            barrier(mesh.device)
        return
    runner = SwarmFarmRunner(params, positions_list, swarm_ids, seed, use_anm,
                             anm_rec, anm_lig, dtype=dtype,
                             output_root=output_root, energy_mode=energy_mode,
                             energy_chunk=energy_chunk, mesh=mesh)
    if resume:
        resumed = runner.resume_latest()
        if resumed:
            log.info("resumed %d swarms at step %d", runner.n_swarms, resumed)
    runner.run_segmented(steps, segment=segment, metrics=metrics)
