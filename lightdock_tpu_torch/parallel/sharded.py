"""Sharded execution over a mesh of ranks: swarms over the ``swarm`` axis,
receptor atoms over the ``atoms`` axis, or both.

Port of ``lightdock_tpu/parallel/sharded.py`` on ``torch.distributed``, one
process a rank (``parallel.mesh``):

1. :func:`run_multi_swarm`: each rank steps its own block of swarms, with
   no traffic during optimization (the algorithm has none between swarms,
   reference src/swarm.rs:86-102).
2. :func:`atom_sharded_energy` (dense) and
   :func:`make_kernel_atom_sharded_fns` (the pair kernels K1, K2 or K3 on
   the rank's receptor slice): each rank of an atoms row scores its slice
   of receptor atoms against the whole ligand, and the partial sums meet
   in ``all_reduce`` (:func:`_sharded_bias`) before the affine finish and
   the bias.
3. :func:`run_multi_swarm_2d` and :func:`run_multi_swarm_2d_kernel`: both
   at once; the moves run on every rank of a row, on identical reduced
   scores, so the row's copies of its swarms stay bit-equal.

Where JAX runs one SPMD program under ``shard_map``, each rank here runs
its own: the ``run_*`` functions take the rank's block of states (leading
axis the block's swarms, ``mesh.swarm_block``; the one swarm of
:func:`run_single_swarm_atom_sharded` on every rank) and return the
block's final states and outputs.  ``params_atom_specs`` has no
counterpart: there are no PartitionSpecs, each rank slices its own
parameters (:func:`slice_atom_shard`).  The kernel path splits the
receptor, spatially sorted as one body, into contiguous slices of whole
kernel tiles (of whole cull sub-boxes when the receptor has fewer tiles
than ranks): ranks may hold unequal slices, so no inert atoms are added,
and every rank works in the whole receptor's frame.  The kernel modes
score every pose of a block in one call: no pose-chunk wrapper.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..engine.energy_dense import batch_energy_parts, finalize_raw
from ..engine.energy_kernel import (frame_center, kernel_params,
                                    make_kernel_energy_fn)
from ..engine.gso import StepOutput, run_swarm, swarms_step
from ..engine.params import BatchScoringParams, torch_params
from ..ops.tiling import R_SUB, R_TILE, anm_mode_bounds

# The receptor-atom axis of each params field (copy of JAX's
# ``_REC_ATOM_DIM``).
_REC_ATOM_DIM = {
    "rec_coords": 0, "rec_nmodes": 1, "rec_res_onehot": 1,
    "rec_membrane_mask": 0, "atom_types_rec": 0,
    "ele_rec": 0, "vdw_c_rec": 0, "vdw_r_rec": 0,
    "dfire_dq": 1,  # (K, Nr, Nl)
    "dfire_rec_half": 1,  # (K, Nr, TYPE_PAD)
}


# -- swarm-axis data parallelism -------------------------------------------

def run_multi_swarm(mesh, params: BatchScoringParams, states, randoms,
                    energy_chunk: int = 0):
    """Step this rank's block of swarms with the dense energy, every pose
    of the block in one call (``energy_chunk`` > 0 caps a call's poses).
    ``states`` leads with the block's swarms, ``randoms`` is (steps,
    S_block, G).  Returns (final states, StepOutput with fields (steps,
    S_block, ...))."""
    from ..engine.energy_dense import batch_energy_chunked

    p = torch_params(params, mesh.device, states.t.dtype)
    energy_fn = functools.partial(batch_energy_chunked, chunk=energy_chunk)
    return _run_swarms(p, states, randoms, energy_fn)


def _run_swarms(p, states, randoms, energy_fn):
    outs = []
    for r in randoms:
        states, out = swarms_step(p, states, r, energy_fn)
        outs.append(out)
    return states, StepOutput(*(torch.stack(f) for f in zip(*outs)))


# -- receptor-atom-axis sharding -------------------------------------------

def pad_params_for_atom_sharding(params: BatchScoringParams,
                                 n_shards: int) -> BatchScoringParams:
    """Pad the receptor-atom dimension to a multiple of ``n_shards`` (copy
    of JAX's, for the dense path).  Padding atoms are inert: coordinates at
    1e6 fail every distance cutoff."""
    nr = params.rec_coords.shape[0]
    pad = (-nr) % n_shards
    if pad == 0:
        return params

    def pad_axis(x, axis, value=0.0):
        if x is None:
            return None
        x = np.asarray(x)
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths, constant_values=value)

    return dataclasses.replace(
        params,
        rec_coords=pad_axis(params.rec_coords, 0, 1e6),
        rec_nmodes=pad_axis(params.rec_nmodes, 1),
        rec_res_onehot=pad_axis(params.rec_res_onehot, 1),
        rec_membrane_mask=pad_axis(params.rec_membrane_mask, 0),
        atom_types_rec=pad_axis(params.atom_types_rec, 0),
        ele_rec=pad_axis(params.ele_rec, 0),
        vdw_c_rec=pad_axis(params.vdw_c_rec, 0),
        vdw_r_rec=pad_axis(params.vdw_r_rec, 0, 1.0),
        dfire_dq=pad_axis(params.dfire_dq, 1),
        dfire_rec_half=pad_axis(params.dfire_rec_half, 1),
    )


def atom_shard_bounds(nr: int, n_shards: int, unit: int = 1):
    """[(start, stop)] of ``n_shards`` contiguous receptor slices made of
    whole ``unit``-atom groups, as even as groups go (the first slices one
    group longer where they do not divide; the last slice ends at ``nr``).
    Raises where a slice would be empty."""
    n_units = -(-nr // unit)
    if n_units < n_shards:
        raise ValueError(f"{nr} receptor atoms make {n_units} groups of {unit}, "
                         f"fewer than {n_shards} shards")
    per, extra = divmod(n_units, n_shards)
    bounds, start = [], 0
    for s in range(n_shards):
        stop = start + (per + (s < extra)) * unit
        bounds.append((start, min(stop, nr)))
        start = stop
    return bounds


def slice_atom_shard(params: BatchScoringParams, s: int, n_shards: int,
                     unit: int = 1) -> BatchScoringParams:
    """Shard ``s``'s contiguous receptor-atom slice (:func:`atom_shard_bounds`;
    the ligand and ``rec_num_membrane``, the whole receptor's count, are
    kept).  With ``unit`` 1 and ``n_shards`` dividing Nr, JAX's equal
    slices."""
    start, stop = atom_shard_bounds(np.asarray(params.rec_coords).shape[0],
                                    n_shards, unit)[s]
    kwargs = {}
    for f in dataclasses.fields(BatchScoringParams):
        v = getattr(params, f.name)
        if f.name in _REC_ATOM_DIM and v is not None:
            v = np.asarray(v)
            sl = [slice(None)] * v.ndim
            sl[_REC_ATOM_DIM[f.name]] = slice(start, stop)
            v = v[tuple(sl)]
        kwargs[f.name] = v
    return BatchScoringParams(**kwargs)


def _all_reduce(x, op, group):
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _sharded_bias(p_local, raw, iface_rec_loc, iface_lig_part, group):
    """Final biased scores from this shard's energy parts.

    Collectives over ``group`` (the mesh's atoms row; None for one shard):
    one ``SUM`` of the raw pair sums, the per-residue interface hit counts
    of the shard's receptor atoms (residues may span shards, so counts add
    before the ``> 0`` threshold, reference src/scoring.rs:21-36) and the
    membrane-bead intersections (over the whole receptor's bead count);
    one ``MAX`` of the ligand interface flags (an OR).  Every rank of the
    row enters both whatever its poses, so none waits on another."""
    g = raw.shape[0]
    if iface_rec_loc is None:
        # No restraints, no membrane: the bias is the identity.
        return finalize_raw(p_local, _all_reduce(raw, dist.ReduceOp.SUM, group))
    n_res = p_local.rec_res_onehot.shape[0]
    membrane = p_local.rec_num_membrane > 0
    sums = [raw[:, None]]
    if n_res > 0:
        sums.append(torch.einsum("rn,gn->gr", p_local.rec_res_onehot, iface_rec_loc))
    if membrane:
        sums.append(torch.einsum("n,gn->g", p_local.rec_membrane_mask,
                                 iface_rec_loc)[:, None])
    sums = _all_reduce(torch.cat(sums, dim=1), dist.ReduceOp.SUM, group)
    iface_lig = _all_reduce(iface_lig_part.contiguous(), dist.ReduceOp.MAX, group)
    score = finalize_raw(p_local, sums[:, 0])
    zeros = torch.zeros(g, dtype=score.dtype, device=score.device)
    fr = ((sums[:, 1:1 + n_res] > 0).to(score.dtype).mean(dim=1) if n_res > 0
          else zeros)
    if p_local.lig_res_onehot.shape[0] > 0:
        lhits = torch.einsum("rn,gn->gr", p_local.lig_res_onehot, iface_lig)
        fl = (lhits > 0).to(score.dtype).mean(dim=1)
    else:
        fl = zeros
    penalty = (C.MEMBRANE_PENALTY_SCORE * (sums[:, -1] / p_local.rec_num_membrane)
               if membrane else zeros)
    return score + fr * score + fl * score - penalty


def atom_sharded_energy(p_local: BatchScoringParams, t, q, a_rec, a_lig,
                        group=None, moved=None, prev_scoring=None):
    """Dense pair energy with receptor atoms sharded over ``group``:
    ``p_local`` holds this rank's slice (tensors).  ``moved`` and
    ``prev_scoring`` are accepted and ignored, as in JAX: recomputing an
    unmoved pose gives its stored score."""
    raw, ifr, ifl = batch_energy_parts(p_local, t, q, a_rec, a_lig)
    return _sharded_bias(p_local, raw, ifr, ifl, group)


def _dense_shard(mesh, params, dtype):
    n = mesh.n_atoms
    shard = slice_atom_shard(pad_params_for_atom_sharding(params, n),
                             mesh.coord[1], n)
    energy_fn = functools.partial(atom_sharded_energy, group=mesh.atom_group)
    return torch_params(shard, mesh.device, dtype), energy_fn


def run_single_swarm_atom_sharded(mesh, params: BatchScoringParams, state,
                                  randoms):
    """One swarm, the dense energy sharded over the mesh's atoms axis; every
    rank passes the same ``state`` and ``randoms`` (steps, G) and ends with
    the same final state.  Returns (final state, StepOutput)."""
    p, energy_fn = _dense_shard(mesh, params, state.t.dtype)
    return run_swarm(p, state, randoms, energy_fn)


def run_multi_swarm_2d(mesh, params: BatchScoringParams, states, randoms):
    """This rank's block of swarms with the dense energy's receptor atoms
    sharded over its atoms row (:func:`run_multi_swarm`'s arguments and
    result)."""
    p, energy_fn = _dense_shard(mesh, params, states.t.dtype)
    return _run_swarms(p, states, randoms, energy_fn)


# -- receptor-atom sharding composed with the pair kernels ------------------

def shard_unit(nr: int, n_shards: int) -> int:
    """Atoms of the groups the kernel path splits the receptor into: whole
    kernel tiles, or whole cull sub-boxes where the receptor has fewer
    tiles than shards (slices never cut the RCB boxes the cull reads)."""
    return R_TILE if -(-nr // R_TILE) >= n_shards else R_SUB


def make_kernel_atom_sharded_fns(params: BatchScoringParams, mesh,
                                 dtype: torch.dtype = torch.float32,
                                 cull: bool = True):
    """The kernel energy path with receptor atoms sharded over the mesh's
    atoms row (counterpart of JAX's ``make_pallas_atom_sharded_fns``).

    The receptor is spatially sorted as one body (``kernel_params``, the
    v2 kernels' tables) and this rank takes its slice of whole tiles
    (:func:`shard_unit`); its cull boxes are its own, its frame centre and
    receptor mode bounds the whole receptor's.  Its pair kernel (K1, K2
    where the slice's own grid reaches ``energy_kernel.WORKLIST_MIN_TILES``
    tile pairs, K3 for DNA and PYDOCK) scores the slice.

    Returns ``(p_local, energy_fn)``: the slice's tensors on
    ``mesh.device`` and ``energy_fn(p_local, t, q, a_rec, a_lig,
    moved=None, prev_scoring=None) -> (G,)``, which combines the shards
    (:func:`_sharded_bias`) and then keeps the stored score of each pose
    ``moved`` leaves out.  ``energy_fn.kernel`` is the slice's kernel."""
    full = kernel_params(params, "v2")
    n = mesh.n_atoms
    shard = slice_atom_shard(full, mesh.coord[1], n,
                             shard_unit(full.rec_coords.shape[0], n))
    parts_fn = make_kernel_energy_fn(
        shard, mesh.device, dtype, cull=cull, kernel="v2", shard_parts=True,
        center=frame_center(full), rec_bounds=anm_mode_bounds(full.rec_nmodes))
    group = mesh.atom_group

    def energy_fn(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None):
        gate = moved if prev_scoring is not None else None
        raw, ifr, ifl = parts_fn(p, t, q, a_rec, a_lig, gate)
        scores = _sharded_bias(p, raw, ifr, ifl, group)
        if gate is None:
            return scores
        return torch.where(gate, scores, prev_scoring)

    energy_fn.kernel = parts_fn.kernel
    energy_fn.kernel_args = parts_fn.kernel_args
    return torch_params(shard, mesh.device, dtype), energy_fn


def run_multi_swarm_2d_kernel(mesh, params: BatchScoringParams, states,
                              randoms, cull: bool = True):
    """This rank's block of swarms with the pair kernels on its receptor
    slice (counterpart of JAX's ``run_multi_swarm_2d_pallas``;
    :func:`run_multi_swarm`'s arguments and result).  One kernel call a
    step scores the block's S_block x G poses; unmoved poses keep their
    stored score."""
    p, energy_fn = make_kernel_atom_sharded_fns(params, mesh, states.t.dtype,
                                                cull=cull)
    return _run_swarms(p, states, randoms, energy_fn)
