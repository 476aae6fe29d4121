"""Swarms as a batch axis: stacked states, their random draws, their
snapshots.

Port of the single-process parts of ``lightdock_tpu/parallel/multihost.py``
(``stack_swarm_states``, ``swarm_randoms``, ``write_swarm_outputs``).  The
reference farms swarms out as one OS process each; here S swarms share one
program on one GPU, every state field leading with the swarm axis.  Every
swarm uses the same random stream: the reference seeds every swarm process
with the same setup.json seed.  The multi-host parts (``jax.distributed``,
the per-host addressable shards) wait for the port's multi-GPU path.
"""

from __future__ import annotations

import pathlib
from typing import List, Sequence

import numpy as np
import torch

from ..engine.gso import SwarmState, init_state
from ..utils.output import write_gso_output, write_state_sidecar
from ..utils.rng import uniform_f64_stream


def stack_swarm_states(positions_list: Sequence[np.ndarray], use_anm: bool,
                       anm_rec: int, anm_lig: int, dtype: torch.dtype,
                       device) -> SwarmState:
    """S swarms' initial states stacked on a leading axis."""
    states = [init_state(p, use_anm, anm_rec, anm_lig, dtype=dtype, device=device)
              for p in positions_list]
    return SwarmState(*(torch.stack(xs) for xs in zip(*states)))


def swarm_randoms(seed: int, steps: int, n_swarms: int, g: int,
                  start_step: int = 0) -> np.ndarray:
    """(steps - start_step, S, G) uniform draws, the same stream for every
    swarm."""
    r = uniform_f64_stream(seed, steps * g)[start_step * g:].reshape(-1, g)
    return np.broadcast_to(r[:, None, :], (r.shape[0], n_swarms, g)).copy()


def write_swarm_outputs(outs, swarm_ids: List[int], use_anm: bool,
                        steps: int, output_root=".", start_step: int = 0,
                        sidecars: bool = False) -> None:
    """Write ``swarm_<id>/gso_<step>.out`` from a stacked ``StepOutput``
    whose fields are (steps, S, ...), for the steps after ``start_step`` up
    to ``steps`` in the reference's cadence (step 1 and every tenth);
    ``sidecars`` adds the full-precision ``.npz`` state beside each
    snapshot."""
    host = {name: getattr(outs, name).cpu().numpy() for name in outs._fields}
    root = pathlib.Path(output_root)
    for s_idx, swarm_id in enumerate(swarm_ids):
        outdir = root / f"swarm_{swarm_id}"
        for step in range(start_step + 1, steps + 1):
            if not (step % 10 == 0 or step == 1):
                continue
            i = step - 1 - start_step
            local = {name: x[i, s_idx] for name, x in host.items()}
            outdir.mkdir(parents=True, exist_ok=True)
            cols = [local["t"], local["q"]]
            if use_anm and local["a_rec"].shape[-1] > 0:
                cols.append(local["a_rec"])
            if use_anm and local["a_lig"].shape[-1] > 0:
                cols.append(local["a_lig"])
            path = outdir / f"gso_{step}.out"
            write_gso_output(path, np.concatenate(cols, axis=1).astype(np.float64),
                             local["luciferin"].astype(np.float64),
                             local["num_neighbors"],
                             local["vision"].astype(np.float64),
                             local["scoring"].astype(np.float64))
            if sidecars:
                write_state_sidecar(path, step,
                                    **{k: local[k] for k in SwarmState._fields})
