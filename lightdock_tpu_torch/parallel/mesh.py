"""The (swarm, atoms) mesh of ranks: which swarms and which receptor atoms a
rank owns, on which device.

Port of ``lightdock_tpu/parallel/mesh.py``.  The reference farms swarms out
as OS processes (reference example/1czy/execution.sh:21-24); here they
split over the ``swarm`` axis of a mesh of ``torch.distributed`` ranks, one
process a rank, with the scoring parameters copied to every rank.  The
``atoms`` axis also splits the receptor atoms of the pair energy; the
partial sums meet in ``all_reduce`` over the ranks of one row of the mesh
(``parallel.sharded``).

Rank r sits at (r // n_atoms, r % n_atoms), as JAX lays its device grid
out.  JAX's ``swarm_sharding``, ``replicated``, ``shard_swarm_states`` and
``replicate_params`` have no counterpart: each rank stacks only its own
block of swarms (:meth:`Mesh.swarm_block`) and uploads the parameters once
to its own device (``engine.params.torch_params``).  The swarm axis carries
no traffic, so the mesh holds one process group, its row's over the atoms
axis.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..engine.runner import cuda_device

SWARM_AXIS = "swarm"
ATOM_AXIS = "atoms"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_swarm`` x ``n_atoms`` mesh of ranks.
    ``atom_group`` is the process group of the ranks that share this
    rank's swarms and split the receptor atoms (None when ``n_atoms`` is
    1: no collective is needed)."""

    n_swarm: int
    n_atoms: int
    rank: int
    device: torch.device
    atom_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {SWARM_AXIS: self.n_swarm, ATOM_AXIS: self.n_atoms}

    @property
    def size(self) -> int:
        return self.n_swarm * self.n_atoms

    @property
    def coord(self) -> tuple:
        """(swarm, atoms) coordinate of this rank."""
        return divmod(self.rank, self.n_atoms)

    def swarm_block(self, n_swarms: int) -> range:
        """The contiguous swarm indices this rank runs, of ``n_swarms``:
        as even as blocks go, the first blocks one swarm longer where
        ``n_swarms`` does not divide (no padding swarms, unlike JAX's equal
        shards)."""
        if n_swarms < self.n_swarm:
            raise ValueError(f"{n_swarms} swarms for {self.n_swarm} ranks on the "
                             "swarm axis: every rank needs a swarm")
        per, extra = divmod(n_swarms, self.n_swarm)
        s = self.coord[0]
        start = s * per + min(s, extra)
        return range(start, start + per + (s < extra))


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``; 0 for one process)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device="cuda") -> torch.device:
    """``device`` as this rank's device: a bare ``cuda`` is card
    ``LOCAL_RANK`` modulo the cards torch sees (ranks that outnumber the
    cards share them, and then take the gloo backend,
    ``multihost.default_backend``); ``cpu`` and an indexed card are taken
    as given.  Raises without a card unless the CPU is asked for."""
    device = cuda_device(device, "the mesh")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def make_mesh(n_swarm: Optional[int] = None, n_atoms: int = 1,
              device="cuda") -> Mesh:
    """The (swarm, atoms) mesh over the world's ranks; ``n_swarm`` defaults
    to world / ``n_atoms``.  The process group must be initialised first
    (``multihost.maybe_initialize_distributed``) unless the world is one
    process.  Every rank must call this, in the same order as any other
    group it makes: it creates one process group a mesh row.  Unlike
    JAX's, the mesh must take every rank: a rank outside it would have
    nothing to do."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_swarm is None:
        n_swarm = world // n_atoms
    if n_swarm < 1 or n_atoms < 1 or n_swarm * n_atoms != world:
        raise ValueError(f"a {n_swarm} x {n_atoms} mesh over {world} ranks")
    atom_group = None
    if n_atoms > 1:
        for s in range(n_swarm):
            group = dist.new_group(list(range(s * n_atoms, (s + 1) * n_atoms)))
            if s == rank // n_atoms:
                atom_group = group
    return Mesh(n_swarm, n_atoms, rank, rank_device(device), atom_group)
