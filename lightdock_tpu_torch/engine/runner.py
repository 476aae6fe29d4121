"""Host-facing GSO runner on torch.

Port of ``lightdock_tpu/engine/gso_jax.py`` ``GsoJaxRunner``: the
host-side rand-0.7 stream (reference RNG mode), the energy modes, ``run``,
``run_segmented``, ``reset``, ``load_snapshot`` from a ``.npz`` sidecar,
and the ``gso_N.out`` snapshots with their sidecars (``utils.output``),
with ANM coefficients when ``use_anm``.  The energy modes
(:func:`make_energy`) are 'kernel' (JAX's 'pallas': the v2 kernels of
``engine.energy_kernel``), 'kernel_v1' ('pallas_v1': K4 and K5), 'dense'
('xla': ``energy_dense.batch_energy_chunked``) and 'auto', which is
'kernel': the JAX crossover map was measured on a TPU, and the port's own
rule waits for H100 data.  A kernel runs on the card (the default device);
where the caller asks for the CPU, its plain version runs instead.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import Optional

import numpy as np
import torch

from ..utils.output import (read_state_sidecar, write_gso_output,
                            write_state_sidecar)
from ..utils.rng import uniform_f64_stream
from .energy_dense import batch_energy_chunked
from .energy_kernel import (kernel_params, make_kernel_energy_fn,
                            pose_chunked_energy)
from .gso import StepOutput, SwarmState, init_state, run_swarm
from .params import BatchScoringParams, torch_params

ENERGY_MODES = ("auto", "kernel", "kernel_v1", "dense")


def cuda_device(device, who: str) -> torch.device:
    """``device`` as a torch device; raises for a GPU that torch does not
    see (no fallback to the CPU).  Turns TF32 off: it would move pairs
    across DFIRE bin edges and loosen the cull bounds."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on a CUDA GPU unless given "
                           "device='cpu', and torch sees none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def make_energy(params: BatchScoringParams, energy_mode: str, device,
                dtype: torch.dtype, energy_chunk: int = 0, dq_bf16: bool = False,
                cull: bool = True):
    """(tensor params, energy_fn) of an energy mode (see the module
    docstring).  ``energy_chunk`` > 0 caps the poses of one call: dense
    chunks, or kernel calls through ``pose_chunked_energy``; 0 scores every
    pose at once.  ``dq_bf16`` stores the DFIRE step tables in bfloat16
    where the mode reads them ('kernel_v1', 'dense' with step-form params);
    each value is upcast before it is added.  ``cull`` False gives the
    kernel modes every tile of every pose (``make_kernel_energy_fn``); the
    dense mode has no cull and ignores it, as JAX's 'xla' mode does."""
    if energy_mode not in ENERGY_MODES:
        raise ValueError(f"energy_mode must be one of {ENERGY_MODES}, got "
                         f"{energy_mode!r}")
    if energy_mode == "dense":
        energy_fn = functools.partial(batch_energy_chunked, chunk=energy_chunk)
    else:
        kernel = "v1" if energy_mode == "kernel_v1" else "v2"
        params = kernel_params(params, kernel)
        energy_fn = make_kernel_energy_fn(params, device, dtype, cull=cull,
                                          kernel=kernel)
        if energy_chunk > 0:
            energy_fn = pose_chunked_energy(energy_fn, energy_chunk)
    tparams = torch_params(params, device, dtype)
    if dq_bf16 and tparams.dfire_dq is not None:
        tparams = dataclasses.replace(
            tparams, dfire_dq=tparams.dfire_dq.to(torch.bfloat16))
    return tparams, energy_fn


class GsoTorchRunner:
    """Runs one swarm: precomputes the random stream, steps the swarm on
    ``device`` and writes snapshots in the reference's cadence and
    format."""

    def __init__(self, params: BatchScoringParams, positions, seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 output_directory: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 energy_mode: str = "kernel", energy_chunk: int = 0,
                 dq_bf16: bool = False, cull: bool = True):
        device = cuda_device(device, "GsoTorchRunner")
        self.params, self.energy_fn = make_energy(
            params, energy_mode, device, dtype, energy_chunk, dq_bf16, cull)
        self.device = device
        self.state = init_state(positions, use_anm, anm_rec, anm_lig,
                                dtype=dtype, device=device)
        self._initial_state = self.state
        self.use_anm = use_anm
        self.output_directory = output_directory
        self._stream = functools.partial(uniform_f64_stream, seed)
        self._start_step = 0  # completed steps

    def reset(self) -> None:
        """Rewind to the initial swarm state.  Timed repeats must restart
        the trajectory: a converged swarm moves fewer poses, and the
        rescoring gate would make it look faster."""
        self._start_step = 0
        self.state = self._initial_state

    def load_snapshot(self, path, step: Optional[int] = None) -> None:
        """Resume from the ``.npz`` sidecar of a ``gso_N.out`` snapshot;
        the resumed run is bit-identical to the uninterrupted one."""
        sidecar = read_state_sidecar(path)
        if sidecar is None:
            raise FileNotFoundError(
                f"no sidecar next to {path}; resuming from the text snapshot "
                "alone comes in a later port")
        sc_step, arrays = sidecar
        self.state = SwarmState(**{
            k: torch.as_tensor(arrays[k], device=self.device)
            for k in SwarmState._fields})
        self._start_step = int(step) if step else sc_step

    def _randoms(self, steps: int) -> torch.Tensor:
        g = self.state.t.shape[0]
        r = self._stream(steps * g)[self._start_step * g:].reshape(-1, g)
        return torch.as_tensor(r, dtype=self.state.t.dtype, device=self.device)

    def run(self, steps: int):
        """Run to ``steps`` completed steps; returns (state, StepOutput)."""
        if steps <= self._start_step:
            return self.state, None
        start = self._start_step
        self.state, outs = run_swarm(self.params, self.state,
                                     self._randoms(steps), self.energy_fn)
        if self.output_directory is not None:
            self._write_snapshots(outs, steps, start)
        self._start_step = steps
        return self.state, outs

    def run_segmented(self, steps: int, segment: int = 10):
        """Run to ``steps`` in segments of ``segment`` steps, writing each
        segment's snapshots as it ends: a crash loses at most a segment."""
        randoms = self._randoms(steps)
        base = self._start_step
        outs = None
        while self._start_step < steps:
            start = self._start_step
            target = min(start + segment, steps)
            self.state, outs = run_swarm(self.params, self.state,
                                         randoms[start - base:target - base],
                                         self.energy_fn)
            if self.output_directory is not None:
                self._write_snapshots(outs, target, start)
            self._start_step = target
        return self.state, outs

    def _poses_at(self, outs: StepOutput, i: int) -> np.ndarray:
        cols = [outs.t[i], outs.q[i]]
        if self.use_anm and outs.a_rec.shape[-1] > 0:
            cols.append(outs.a_rec[i])
        if self.use_anm and outs.a_lig.shape[-1] > 0:
            cols.append(outs.a_lig[i])
        return torch.cat(cols, dim=1).cpu().numpy().astype(np.float64)

    def _write_snapshots(self, outs: StepOutput, steps: int, start: int) -> None:
        outdir = pathlib.Path(self.output_directory)
        outdir.mkdir(parents=True, exist_ok=True)
        for step in range(start + 1, steps + 1):
            if step % 10 == 0 or step == 1:
                i = step - 1 - start
                path = outdir / f"gso_{step}.out"
                host = {k: getattr(outs, k)[i].cpu().numpy()
                        for k in SwarmState._fields}
                write_gso_output(path, self._poses_at(outs, i),
                                 host["luciferin"].astype(np.float64),
                                 host["num_neighbors"],
                                 host["vision"].astype(np.float64),
                                 host["scoring"].astype(np.float64))
                # The StepOutput after step i is the post-step state.
                write_state_sidecar(path, step, **host)
