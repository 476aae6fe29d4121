"""The port's sharded execution (``lightdock_tpu_torch.parallel.sharded``)
on gloo ranks on the CPU, against ``lightdock_tpu.parallel.sharded`` on the
8 virtual CPU devices, at float64.

The system is tests/test_parallel.py's (30 x 18 atoms, 2 + 2 ANM modes, 2
membrane beads, restraints on two residues a side, 16 glowworms, 4 steps),
with 4 swarms drawn after it for the 2-D runs.  One spawn of 2 ranks and
one of 4 run every case and save what they compute; the tests compare.
The ranks import this module, so JAX and the JAX package are imported
inside the tests only: a rank never loads them."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch.engine.energy_dense import bias, finalize_raw  # noqa: E402
from lightdock_tpu_torch.engine.gso import SwarmState, init_state  # noqa: E402
from lightdock_tpu_torch.engine.params import torch_params  # noqa: E402
from lightdock_tpu_torch.parallel import sharded  # noqa: E402
from lightdock_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from lightdock_tpu_torch.parallel.multihost import (  # noqa: E402
    maybe_initialize_distributed, spawn_local, stack_swarm_states)

G, STEPS, NUM_ANM, S = 16, 4, 2, 4
TOL = dict(rtol=1e-9, atol=1e-9)   # JAX's own for reordered sums
F64 = torch.float64
RANK_TIMEOUT = 120   # seconds a collective waits: a rank whose peer died fails


# -- what the ranks run ------------------------------------------------------

def _state(pos):
    return init_state(pos, True, NUM_ANM, NUM_ANM, F64, "cpu")


def _states(positions):
    return stack_swarm_states(positions, True, NUM_ANM, NUM_ANM, F64, "cpu")


def _block(states, block):
    return SwarmState(*(x[block.start:block.stop] for x in states))


def _save(x):
    if isinstance(x, tuple):   # SwarmState, StepOutput
        return {k: v.clone() for k, v in x._asdict().items()}
    return x.clone()


def _bias_parts(rank, n_ranks):
    """Synthetic energy parts of rank ``rank`` of 2, for the three poses of
    ``bias_case``: its half of a 4-atom receptor and a 2-atom ligand."""
    ifr = torch.tensor([[0, 0, 1, 0], [0, 0, 0, 0], [1, 0, 0, 1]], dtype=F64)
    ifl = torch.tensor([[0, 0], [rank, 0], [0, 0]], dtype=F64)
    raw = torch.tensor([1.5, -2.0, 0.25], dtype=F64) * (rank + 1)
    half = ifr.shape[1] // n_ranks
    return raw, ifr[:, rank * half:(rank + 1) * half], ifl


def bias_case(params, rank=None):
    """The restraints and membrane of ``_bias_parts``' receptor, whole or
    rank ``rank``'s half.  Pose 0: a receptor residue (atoms 1, 2) hit
    only on rank 1's atom; pose 1: the ligand's restrained atom flagged
    only on rank 1; pose 2: membrane beads 0 and 3 hit, one on each
    rank."""
    cols = slice(None) if rank is None else slice(2 * rank, 2 * rank + 2)
    return dataclasses.replace(
        params,
        rec_res_onehot=torch.tensor([[0, 1, 1, 0], [0, 0, 0, 1]], dtype=F64)[:, cols],
        lig_res_onehot=torch.tensor([[1, 0]], dtype=F64),
        rec_membrane_mask=torch.tensor([1, 0, 0, 1], dtype=F64)[cols],
        rec_num_membrane=2)


def two_ranks(rank, params, positions, randoms, out):
    torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", timeout=RANK_TIMEOUT)
    atoms = make_mesh(n_swarm=1, n_atoms=2, device="cpu")
    swarms = make_mesh(n_swarm=2, n_atoms=1, device="cpu")
    res = {}
    state = _state(positions[0])
    pose = (state.t, state.q, state.a_rec, state.a_lig)
    rnd = torch.as_tensor(randoms)
    p_loc = torch_params(sharded.slice_atom_shard(
        sharded.pad_params_for_atom_sharding(params, 2), rank, 2), "cpu", F64)
    res["dense_energy"] = sharded.atom_sharded_energy(p_loc, *pose,
                                                      group=atoms.atom_group)
    for cull in (True, False):
        p_k, energy_fn = sharded.make_kernel_atom_sharded_fns(params, atoms, F64,
                                                              cull=cull)
        res[f"kernel_energy_cull{cull}"] = energy_fn(p_k, *pose)
    raw, ifr, ifl = _bias_parts(rank, 2)
    res["bias"] = sharded._sharded_bias(bias_case(p_loc, rank), raw, ifr, ifl,
                                        atoms.atom_group)
    final, outs = sharded.run_single_swarm_atom_sharded(atoms, params, state, rnd)
    res["single"], res["single_scoring"] = _save(final), outs.scoring
    states = _states(positions)
    rnd_s = rnd[:, None].expand(STEPS, S, G).contiguous()
    for cull in (True, False):
        final, outs = sharded.run_multi_swarm_2d_kernel(atoms, params, states,
                                                        rnd_s, cull=cull)
        res[f"2d_kernel_cull{cull}"] = _save(final)
    res["2d_kernel_outs_t"] = outs.t
    res["2d_dense"] = _save(sharded.run_multi_swarm_2d(atoms, params, states, rnd_s)[0])
    block = swarms.swarm_block(S)
    res["dp_block"] = (block.start, block.stop)
    res["dp"] = _save(sharded.run_multi_swarm(swarms, params, _block(states, block),
                                              rnd_s[:, block.start:block.stop])[0])
    torch.save(res, out / f"rank{rank}.pt")


def four_ranks(rank, params, positions, randoms, out):
    torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", timeout=RANK_TIMEOUT)
    atoms = make_mesh(n_swarm=1, n_atoms=4, device="cpu")
    grid = make_mesh(n_swarm=2, n_atoms=2, device="cpu")
    res = {}
    state = _state(positions[0])
    pose = (state.t, state.q, state.a_rec, state.a_lig)
    rnd = torch.as_tensor(randoms)
    p_k, energy_fn = sharded.make_kernel_atom_sharded_fns(params, atoms, F64)
    res["kernel_energy"] = energy_fn(p_k, *pose)
    res["shard_atoms"] = p_k.rec_coords.shape[0]
    final, _ = sharded.run_single_swarm_atom_sharded(atoms, params, state, rnd)
    res["single"] = _save(final)
    block = grid.swarm_block(S)
    res["block"] = (block.start, block.stop)
    rnd_s = rnd[:, None].expand(STEPS, S, G).contiguous()
    final, _ = sharded.run_multi_swarm_2d_kernel(
        grid, params, _block(_states(positions), block),
        rnd_s[:, block.start:block.stop])
    res["2d_kernel"] = _save(final)
    torch.save(res, out / f"rank{rank}.pt")


# -- the tests ------------------------------------------------------------------

@pytest.fixture(scope="module")
def system():
    """tests/test_parallel.py's system, draw for draw, then 3 more swarms:
    (JAX params, the port's params, [S positions], randoms (STEPS, G))."""
    from lightdock_tpu.engine.energy_batch import build_batch_params
    from lightdock_tpu.scoring.models import DockingModel
    from lightdock_tpu.scoring.potentials import synthetic_potential
    from lightdock_tpu.utils.rng import uniform_f64_stream
    from lightdock_tpu_torch.engine.params import from_reference

    rng = np.random.RandomState(11)

    def model(n):
        return DockingModel(
            method="dfire",
            coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=NUM_ANM,
            nmodes=rng.standard_normal((NUM_ANM, n, 3)) * 0.1,
            membrane=np.array([1, 3], dtype=np.int64),
            active_restraints={"A.X.1": [0, 2], "A.X.2": [4]},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32))

    rec, lig = model(30), model(18)
    params = build_batch_params(rec, lig, use_anm=True,
                                potential=synthetic_potential())

    def positions():
        pos = np.concatenate([
            rng.uniform(-5, 5, (G, 3)), rng.standard_normal((G, 4)),
            rng.uniform(-1, 1, (G, NUM_ANM)), rng.uniform(-1, 1, (G, NUM_ANM))],
            axis=1)
        pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
        return pos

    pos = [positions() for _ in range(S)]
    randoms = uniform_f64_stream(1, STEPS * G).reshape(STEPS, G)
    return params, from_reference(params), pos, randoms


def spawn_in_thread(fn, world, *args):
    """Start ``spawn_local(fn, world, *args)`` in a thread; returns a
    function that waits for it (raising what it raised)."""
    box = {}

    def target():
        try:
            spawn_local(fn, world, *args)
        except BaseException as exc:  # handed to the waiting test
            box["error"] = exc

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def wait():
        thread.join(timeout=600)
        assert not thread.is_alive(), f"{fn.__name__} on {world} ranks did not end"
        if "error" in box:
            raise box["error"]

    return wait


@pytest.fixture(scope="module")
def runs(system, tmp_path_factory):
    """Both spawns, run while this process computes JAX's references."""
    _, params, pos, randoms = system
    outs, waits = {}, {}
    for fn, world in ((two_ranks, 2), (four_ranks, 4)):
        outs[world] = tmp_path_factory.mktemp(fn.__name__)
        waits[world] = spawn_in_thread(fn, world, params, pos, randoms, outs[world])
    result = {"jax": _jax_ref(system)}
    for world, wait in waits.items():
        wait()
        result[world] = [torch.load(outs[world] / f"rank{r}.pt") for r in range(world)]
    return result


@pytest.fixture(scope="module")
def ranks2(runs):
    return runs[2]


@pytest.fixture(scope="module")
def ranks4(runs):
    return runs[4]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs["jax"]


def _jax_ref(system):
    """JAX's sharded runs on the 8 virtual devices: the energy, the
    single-swarm atom-sharded final state, the 2-D Pallas final states in
    interpret mode, the 2-D dense final states, the swarm-parallel final
    states."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.engine.energy_batch import batch_energy
    from lightdock_tpu.engine.gso_jax import device_params
    from lightdock_tpu.engine.gso_jax import init_state as jax_init_state
    from lightdock_tpu.parallel import sharded as jsh
    from lightdock_tpu.parallel.mesh import make_mesh as jax_mesh

    params, _, pos, randoms = system
    state = jax_init_state(pos[0], True, NUM_ANM, NUM_ANM, dtype=jnp.float64)
    states = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jax_init_state(p, True, NUM_ANM, NUM_ANM, dtype=jnp.float64) for p in pos])
    rnd = jnp.asarray(randoms)
    rnd_s = jnp.stack([rnd] * S, axis=1)
    dp = device_params(params, np.float64)
    energy = batch_energy(dp, state.t, state.q, state.a_rec, state.a_lig, xp=jnp)
    single, _ = jsh.run_single_swarm_atom_sharded(jax_mesh(n_swarm=1, n_atoms=2),
                                                  params, state, rnd)
    grid = jax_mesh(n_swarm=4, n_atoms=2)
    pallas, _ = jsh.run_multi_swarm_2d_pallas(grid, params, states, rnd_s,
                                              interpret=True)
    dense, _ = jsh.run_multi_swarm_2d(grid, params, states, rnd_s)
    dp_final, _ = jsh.run_multi_swarm(grid, dp, states, rnd_s)

    def host(tree):
        return {k: np.asarray(v) for k, v in tree._asdict().items()}

    return dict(energy=np.asarray(energy), single=host(single), pallas=host(pallas),
                dense=host(dense), dp=host(dp_final))


def _close(ours, ref, keys=("t", "q", "a_rec", "a_lig", "luciferin", "vision",
                            "scoring")):
    for k in keys:
        np.testing.assert_allclose(ours[k].numpy(), ref[k], **TOL, err_msg=k)
    np.testing.assert_array_equal(ours["num_neighbors"].numpy(), ref["num_neighbors"])


def _rows(ranks, key, block_key="block"):
    """The states of every swarm from the ranks at atoms coordinate 0."""
    parts = sorted((r[block_key], r[key]) for r in ranks)
    seen = {}
    for (start, _), st in parts:
        seen[start] = st
    return {k: torch.cat([seen[s][k] for s in sorted(seen)]) for k in parts[0][1]}


def test_dense_sharded_energy_matches_jax_and_unsharded(ranks2, jax_ref, system):
    """2 ranks: the dense energy with receptor atoms sharded (the raw SUM,
    the ligand flags' MAX, the residue hits' and membrane SUMs) equals the
    unsharded dense energy of the port and JAX's batch_energy."""
    from lightdock_tpu_torch.engine.energy_dense import batch_energy

    _, params, pos, _ = system
    state = _state(pos[0])
    whole = batch_energy(torch_params(params, "cpu", F64), state.t, state.q,
                         state.a_rec, state.a_lig)
    for r in ranks2:
        np.testing.assert_allclose(r["dense_energy"].numpy(), jax_ref["energy"], **TOL)
        np.testing.assert_allclose(r["dense_energy"].numpy(), whole.numpy(), **TOL)


@pytest.mark.parametrize("cull", [True, False])
def test_kernel_sharded_energy_matches_jax(ranks2, jax_ref, cull):
    """2 ranks: the kernel path's parts (K1's plain version on each rank's
    receptor slice) combined across the ranks equal JAX's energy, with the
    cull on and off (test_parallel.py::test_pallas_atom_sharded_energy_matches
    holds JAX's shard_map Pallas energy to the same batch_energy at 1e-9)."""
    for r in ranks2:
        np.testing.assert_allclose(r[f"kernel_energy_cull{cull}"].numpy(),
                                   jax_ref["energy"], **TOL)


def test_kernel_sharded_energy_on_four_ranks(ranks4, jax_ref):
    """4 ranks: a 30-atom receptor is one kernel tile, so it splits into
    whole cull sub-boxes of 8 atoms (8, 8, 8, 6); the combined energy
    equals JAX's."""
    assert [r["shard_atoms"] for r in ranks4] == [8, 8, 8, 6]
    for r in ranks4:
        np.testing.assert_allclose(r["kernel_energy"].numpy(), jax_ref["energy"], **TOL)


@pytest.mark.parametrize("pose,what", [(0, "residue hits SUM"), (1, "ligand flags MAX"),
                                       (2, "membrane SUM")])
def test_sharded_bias_collectives(ranks2, system, pose, what):
    """Each collective of the bias decides one pose's score: the reduced
    score on both ranks equals the unsharded bias of the whole parts, and
    differs from what one rank's flags alone give (the raw sums summed)."""
    _, params, _, _ = system
    tp = torch_params(params, "cpu", F64)
    p = bias_case(tp)
    parts = [_bias_parts(r, 2) for r in range(2)]
    raw = parts[0][0] + parts[1][0]
    ifr = torch.cat([parts[0][1], parts[1][1]], dim=1)
    ifl = torch.maximum(parts[0][2], parts[1][2])
    want = float(bias(p, finalize_raw(p, raw), ifr, ifl)[pose])
    alone = []
    for rank, r in enumerate(ranks2):
        assert float(r["bias"][pose]) == pytest.approx(want, rel=1e-12), what
        _, ifr_r, ifl_r = parts[rank]
        alone.append(float(bias(bias_case(tp, rank), finalize_raw(p, raw), ifr_r,
                                ifl_r)[pose]))
    assert any(a != pytest.approx(want, rel=1e-6) for a in alone), (what, alone, want)


@pytest.mark.parametrize("world", [2, 4])
def test_single_swarm_atom_sharded_matches_jax(ranks2, ranks4, jax_ref, world):
    """run_single_swarm_atom_sharded on 2 and 4 ranks: every rank ends with
    JAX's final state (the scores at 1e-9, the neighbour counts exactly),
    and all ranks' states are bit-equal."""
    ranks = ranks2 if world == 2 else ranks4
    for r in ranks:
        _close(r["single"], jax_ref["single"])
        for k, v in r["single"].items():
            assert torch.equal(v, ranks[0]["single"][k]), k


@pytest.mark.parametrize("cull", [True, False])
def test_2d_kernel_two_ranks_matches_jax(ranks2, jax_ref, cull):
    """run_multi_swarm_2d_kernel on a (1, 2) mesh: 4 swarms, the pair
    kernel's plain version on each rank's receptor slice, against JAX's
    run_multi_swarm_2d_pallas (interpret mode) on a (4, 2) mesh; both ranks
    bit-equal."""
    ours = [r[f"2d_kernel_cull{cull}"] for r in ranks2]
    _close(ours[0], jax_ref["pallas"])
    for k in ours[0]:
        assert torch.equal(ours[0][k], ours[1][k]), k
    assert tuple(ranks2[0]["2d_kernel_outs_t"].shape) == (STEPS, S, G, 3)


def test_2d_kernel_cull_off_equals_cull_on(ranks2):
    """The sharded kernel path with the cull off gives the states and the
    energy of the cull on, bit for bit (the culled tiles add nothing)."""
    for r in ranks2:
        for k, v in r["2d_kernel_cullTrue"].items():
            assert torch.equal(v, r["2d_kernel_cullFalse"][k]), k
        assert torch.equal(r["kernel_energy_cullTrue"], r["kernel_energy_cullFalse"])


def test_2d_kernel_four_ranks_matches_jax(ranks4, jax_ref):
    """run_multi_swarm_2d_kernel on a (2, 2) mesh: each row runs 2 of the 4
    swarms; together they equal JAX's 2-D Pallas run, and the two ranks of
    a row are bit-equal."""
    assert [r["block"] for r in ranks4] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    _close(_rows(ranks4[::2], "2d_kernel"), jax_ref["pallas"])
    for a, b in ((0, 1), (2, 3)):
        for k, v in ranks4[a]["2d_kernel"].items():
            assert torch.equal(v, ranks4[b]["2d_kernel"][k]), (a, b, k)


def test_2d_dense_matches_jax(ranks2, jax_ref):
    """run_multi_swarm_2d (the dense energy sharded) against JAX's."""
    for r in ranks2:
        _close(r["2d_dense"], jax_ref["dense"])


def test_swarm_parallel_matches_jax(ranks2, jax_ref):
    """run_multi_swarm on a (2, 1) mesh: each rank steps 2 of the 4 swarms
    with no collective; together they equal JAX's run_multi_swarm."""
    assert [r["dp_block"] for r in ranks2] == [(0, 2), (2, 4)]
    _close(_rows(ranks2, "dp", "dp_block"), jax_ref["dp"])
