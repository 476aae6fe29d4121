"""Swarms as a batch axis: stacked states, their random draws, their
snapshots, and the processes that run them.

Port of ``lightdock_tpu/parallel/multihost.py``.  The reference farms
swarms out as one OS process each; here S swarms share one program on a
GPU, every state field leading with the swarm axis, and several GPUs (or
processes) each run a block of them as the ranks of ``torch.distributed``
(``parallel.mesh``).  Every swarm uses the same random stream: the
reference seeds every swarm process with the same setup.json seed.

:func:`maybe_initialize_distributed` reads torchrun's environment where
JAX's read ``JAX_COORDINATOR_ADDRESS``; :func:`spawn_local` starts ranks
on this host with that environment (a stand-in for torchrun that a test or
a smoke run can call).  JAX's ``_swarm_local`` is not ported: it works
round global arrays, and a rank holds plain local tensors.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import socket
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..engine.gso import SwarmState, init_state
from ..utils.output import write_gso_output, write_state_sidecar
from ..utils.rng import uniform_f64_stream
from .mesh import rank_device


def default_backend() -> str:
    """'nccl' where the ranks of this host each have a card of their own
    (torchrun's ``LOCAL_WORLD_SIZE`` at most the cards torch sees), else
    'gloo': NCCL refuses two ranks on one device, and a CPU run has none."""
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE",
                                    os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and ranks_here <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(backend=None, timeout=None) -> bool:
    """Initialise ``torch.distributed`` from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) where it is set; without it the run is one process.
    ``backend`` None is :func:`default_backend`'s.  ``timeout`` (seconds;
    None is torch's default) bounds the wait of a collective, so a rank
    whose peer died fails instead of hanging.  A failed init raises: no
    other backend is tried.  Returns True when the world has more than one
    process."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        backend = backend or default_backend()
        if backend == "nccl":
            torch.cuda.set_device(rank_device("cuda"))
        kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return dist.get_world_size() > 1


def barrier(device) -> None:
    """Wait until every rank of the world gets here: an ``all_reduce`` of
    one number on ``device`` (the same on gloo and NCCL), the card
    synchronized after."""
    dist.all_reduce(torch.zeros(1, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    fn(rank, *args)


def spawn_local(fn, world: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``world`` new processes of this host, each
    with torchrun's environment for its rank (``fn`` then calls
    :func:`maybe_initialize_distributed`).  ``fn`` must be importable by
    name.  Returns when every rank has; raises if one fails, after ending
    the others."""
    mp.start_processes(_rank_main, args=(world, _free_port(), fn, args),
                       nprocs=world, join=True, start_method="spawn")


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
                        sidecars: bool = False, mesh=None) -> None:
    """Write ``swarm_<id>/gso_<step>.out`` from a stacked ``StepOutput``
    whose fields are (steps, S, ...), for the steps after ``start_step`` up
    to ``steps`` in the reference's cadence (step 1 and every tenth);
    ``sidecars`` adds the full-precision ``.npz`` state beside each
    snapshot.  With a ``mesh`` (``parallel.mesh.Mesh``), ``swarm_ids``
    names every swarm of the run and ``outs`` holds this rank's block
    (``mesh.swarm_block``): only those swarms are written, and only by the
    rank at atoms coordinate 0, so no two processes write one file."""
    if mesh is not None:
        if mesh.coord[1] != 0:
            return
        swarm_ids = [swarm_ids[i] for i in mesh.swarm_block(len(swarm_ids))]
    if outs.t.shape[1] != len(swarm_ids):
        raise ValueError(f"outputs of {outs.t.shape[1]} swarms for "
                         f"{len(swarm_ids)} swarm ids")
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
