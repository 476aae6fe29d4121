"""The work-list DFIRE kernel (K2) and the per-pose receptor in K1 against
the JAX package.

The plain versions of K2 and of K1 with a (G, Nr, 3) receptor against
``dfire_pairs_pallas_v2(worklist=True|False)`` in Pallas interpret mode on
the same padded inputs and bits; the energy path for DFIRE with receptor
and ligand ANM against ``make_pallas_energy_fn(kernel="v2")`` and the XLA
``batch_energy``, with the work list forced on and left to the rule; the
rule itself.  Tolerances are the v2 kernel tests' (tests/test_pallas.py):
rtol and atol 5e-5 for the f32 summation order; interface flags and the
all-unmoved case are exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lightdock_tpu.engine.energy_batch import (  # noqa: E402
    batch_energy, build_batch_params, ensure_dfire_types)
from lightdock_tpu.engine.energy_pallas import make_pallas_energy_fn  # noqa: E402
from lightdock_tpu.engine.gso_jax import device_params  # noqa: E402
from lightdock_tpu.ops import pallas_energy as pe  # noqa: E402
from lightdock_tpu.ops import quaternion as jqt  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine import energy_dense as ed  # noqa: E402
from lightdock_tpu_torch.engine import energy_kernel as ek  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    frame_center, kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import (  # noqa: E402
    from_reference, torch_params)
from lightdock_tpu_torch.ops import dfire_pairs as dp  # noqa: E402
from lightdock_tpu_torch.ops.tiling import spatial_sort_params  # noqa: E402

TOL = dict(rtol=5e-5, atol=5e-5)
R_TILE, L_TILE = 32, 128


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(num_anm, g=37, n_rec=300, n_lig=170, seed=3, spread=40):
    """``tests/test_pallas.py::_system`` for DFIRE: restraints and a
    membrane on the receptor, ``num_anm`` modes on each side."""
    rng = np.random.RandomState(seed)

    def model(n):
        return DockingModel(
            method="dfire",
            coordinates=rng.uniform(-spread, spread, size=(n, 3)),
            num_anm=num_anm, nmodes=rng.standard_normal((num_anm, n, 3)) * 0.2,
            membrane=np.array([0, 5], dtype=np.int64),
            active_restraints={"A.1": [1, 2], "A.2": [7]},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32))

    params = build_batch_params(model(n_rec), model(n_lig),
                                use_anm=num_anm > 0, dtype=np.float32,
                                potential=synthetic_potential(),
                                dfire_mode="steps")
    t = rng.uniform(-30, 30, (g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a_r = rng.uniform(-1, 1, (g, num_anm))
    a_l = rng.uniform(-1, 1, (g, num_anm))
    return ensure_dfire_types(params), [x.astype(np.float32) for x in (t, q, a_r, a_l)]


def _kernel_inputs(num_anm, gate, g=37, seed=9):
    """Re-centred coordinates (a per-pose receptor with ANM), seeded cull
    and interface bits and the energy path's near bits, padded nowhere: both
    kernels pad them the same way.  Poses are clustered by chunk so that
    some chunk-tiles are far.  ``gate``: 'off', 'on' (about half the poses
    moved) or 'unmoved' (none)."""
    params, pose = _system(num_anm, g=g)
    ours = spatial_sort_params(from_reference(params), R_TILE, L_TILE)
    c = frame_center(ours).astype(np.float32)
    rng = np.random.RandomState(seed)
    n_c = -(-g // dp.POSE_BLOCK)
    t = (np.repeat(rng.uniform(-45, 45, (n_c, 3)), dp.POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3))).astype(np.float32)
    rot = jqt.rotation_matrix(pose[1].astype(np.float64), np).astype(np.float32)
    lig = (np.einsum("gab,nb->gan", rot, ours.lig_coords) + (t - c)[:, :, None]
           + np.einsum("gk,knc->gcn", pose[3], ours.lig_nmodes)).astype(np.float32)
    rec = (ours.rec_coords - c)[None].astype(np.float32)
    if num_anm:
        rec = (rec + np.einsum("gk,knc->gnc", pose[2],
                               ours.rec_nmodes)).astype(np.float32)
    n_r = -(-rec.shape[1] // R_TILE)
    n_l = -(-lig.shape[2] // L_TILE)
    gp = n_c * dp.POSE_BLOCK
    moved = {"off": np.ones(g, bool), "on": rng.rand(g) < 0.5,
             "unmoved": np.zeros(g, bool)}[gate]
    act_pose = (rng.rand(n_r, n_l, g) < 0.8) & moved
    act = np.pad(act_pose, ((0, 0), (0, 0), (0, gp - g))).reshape(
        n_r, n_l, n_c, dp.POSE_BLOCK).any(axis=-1).astype(np.int32)
    iface = ((rng.rand(n_r, n_l, g) < 0.5) & moved).astype(np.int32)
    thr = tuple(float(x) for x in ours.dfire_thresholds)
    split, live = pe.dfire_far_split(thr)
    lp = np.pad(lig, ((0, 0), (0, 0), (0, n_l * L_TILE - lig.shape[2])),
                constant_values=-1e6)
    rp = np.pad(rec, ((0, 0), (0, n_r * R_TILE - rec.shape[1]), (0, 0)),
                constant_values=1e6)
    d2 = ((lp[:, None, :, :] - rp[:, :, :, None]) ** 2).sum(axis=2)
    # Near bits as the energy path makes them: per pose, gated by the moved
    # mask, then OR-ed over the chunk; an unmoved pose in an active chunk
    # may then sit in a far chunk-tile and take a far bin, in both kernels.
    close = (d2 < thr[live[split]]) & moved[:, None, None]
    close = np.pad(close, ((0, gp - g), (0, 0), (0, 0)))
    near = close.reshape(n_c, dp.POSE_BLOCK, n_r, R_TILE, n_l, L_TILE).any(
        axis=(1, 3, 5)).transpose(1, 2, 0).astype(np.int32)
    if gate == "off":
        assert 0 < (near * act).sum() < act.sum()
    return ours, rec, lig, act, iface, near


def _pallas(ours, rec, lig, act, iface, near, worklist):
    thr = tuple(float(x) for x in ours.dfire_thresholds)
    dparams = device_params(ours, np.float32)
    fn = jax.jit(lambda *a: pe.dfire_pairs_pallas_v2(
        *a[:4], thr, *a[4:6], interpret=True, r_tile=R_TILE, l_tile=L_TILE,
        need_iface=True, near_chunks=a[6], p_block=dp.POSE_BLOCK,
        worklist=worklist))
    return fn(jnp.asarray(rec), jnp.asarray(lig), dparams.dfire_rec_half,
              dparams.dfire_lig_onehot, jnp.asarray(act), jnp.asarray(iface),
              jnp.asarray(near))


def _ours(fn, ours, rec, lig, act, iface, near, need_iface=True):
    tp = torch_params(ours, "cpu", torch.float32)
    tables = dp.dfire_tables(tp.dfire_rec_half, tp.dfire_lig_onehot,
                             ours.dfire_thresholds, R_TILE, L_TILE)
    return fn(torch.as_tensor(rec), torch.as_tensor(lig), tables,
              torch.as_tensor(act), torch.as_tensor(iface), r_tile=R_TILE,
              l_tile=L_TILE, need_iface=need_iface,
              near_chunks=torch.as_tensor(near))


def _assert_match(out, ref):
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    for ours, theirs in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("gate", ["off", "on", "unmoved"])
def test_worklist_plain_matches_pallas(num_anm, gate):
    """K2's plain version against the JAX work-list kernel; with every pose
    unmoved the list is empty, raw is zero and the flags are empty."""
    inputs = _kernel_inputs(num_anm, gate)
    ref = _pallas(*inputs, worklist=True)
    before = dp.dfire_pairs_worklist.launches
    out = _ours(dp.dfire_pairs_worklist, *inputs)
    assert dp.dfire_pairs_worklist.launches == before   # the CPU path launches nothing
    assert inputs[1].shape[0] == (37 if num_anm else 1)
    _assert_match(out, ref)
    if gate == "unmoved":
        assert not out[0].any() and not out[1].any() and not out[2].any()
        assert int(dp.worklist(torch.as_tensor(inputs[3]))[1]) == 0
        return
    assert np.abs(np.asarray(ref[0])).max() > 1.0
    assert out[1].sum() > 0 and out[2].sum() > 0
    # K1's plain version gives the same sums within tolerance and the same
    # flags; need_iface=False returns no flags and the same sums.
    k1 = _ours(dp.dfire_pairs_plain, *inputs)
    _assert_match(k1, [x.numpy() for x in out])
    raw, ifr, ifl = _ours(dp.dfire_pairs_worklist_plain, *inputs, need_iface=False)
    assert ifr is None and ifl is None
    np.testing.assert_array_equal(raw.numpy(), out[0].numpy())


@pytest.mark.parametrize("gate", ["off", "on"])
def test_per_pose_receptor_plain_matches_pallas(gate):
    """K1's plain version with a (G, Nr, 3) receptor against the JAX
    kernel on its 2-D grid."""
    inputs = _kernel_inputs(2, gate)
    ref = _pallas(*inputs, worklist=False)
    out = _ours(dp.dfire_pairs, *inputs)
    _assert_match(out, ref)
    assert out[1].sum() > 0 and out[2].sum() > 0


def test_worklist_order():
    """The list holds the tiles with any active chunk first, ascending,
    as the JAX wrapper's stable compaction orders them."""
    act = np.zeros((3, 4, 2), np.int32)
    act[0, 3, 1] = act[2, 0, 0] = act[1, 1, 0] = act[1, 1, 1] = 1
    tiles, n_active = dp.worklist(torch.as_tensor(act))
    assert int(n_active) == 3 and tiles.dtype == torch.int32
    np.testing.assert_array_equal(tiles.numpy()[:3], [3, 5, 8])
    assert sorted(tiles.numpy().tolist()) == list(range(12))


def _both(params, worklist):
    jfn = jax.jit(make_pallas_energy_fn(params, interpret=True, cull=True,
                                        kernel="v2"))
    ours = kernel_params(from_reference(params))
    tfn = make_kernel_energy_fn(ours, "cpu", torch.float32, worklist=worklist)
    return jfn, tfn, torch_params(ours, "cpu", torch.float32)


@pytest.mark.parametrize("worklist", [None, True])
def test_energy_fn_dfire_receptor_anm(monkeypatch, worklist):
    """DFIRE with ANM on both sides through the port's energy path: against
    the JAX kernel path (work list forced, or left to the rule, which picks
    K1 on this 20-tile grid) and the XLA path; the moved gate and the
    all-unmoved case."""
    params, pose = _system(2)
    monkeypatch.setattr(pe, "V2_WORKLIST", bool(worklist))
    jfn, tfn, tp = _both(params, worklist)
    assert tfn.kernel is (dp.dfire_pairs_worklist if worklist else dp.dfire_pairs)
    jp = device_params(params, np.float32)
    jpose = [jnp.asarray(x) for x in pose]
    tpose = [torch.as_tensor(x) for x in pose]
    out = tfn(tp, *tpose).numpy()
    np.testing.assert_allclose(out, np.asarray(jfn(jp, *jpose)), **TOL)
    np.testing.assert_allclose(out, np.asarray(batch_energy(jp, *jpose, xp=jnp)),
                               **TOL)
    g = out.shape[0]
    rng = np.random.RandomState(13)
    moved = rng.rand(g) < 0.5
    prev = rng.uniform(-5, 5, g).astype(np.float32)
    gated = tfn(tp, *tpose, moved=torch.as_tensor(moved),
                prev_scoring=torch.as_tensor(prev)).numpy()
    ref = np.asarray(jfn(jp, *jpose, moved=jnp.asarray(moved),
                         prev_scoring=jnp.asarray(prev)))
    np.testing.assert_array_equal(gated[~moved], prev[~moved])
    np.testing.assert_allclose(gated, ref, **TOL)
    allprev = tfn(tp, *tpose, moved=torch.zeros(g, dtype=torch.bool),
                  prev_scoring=torch.as_tensor(prev))
    np.testing.assert_array_equal(allprev.numpy(), prev)


def test_energy_fn_worklist_matches_k1_f64():
    """At f64 the energy path through K2's plain version equals the one
    through K1's to rounding, and the dense oracle."""
    params, pose = _system(2)
    ours = kernel_params(from_reference(dataclasses.replace(params, dfire_dq=None)))
    tp = torch_params(ours, "cpu", torch.float64)
    tpose = [torch.as_tensor(x.astype(np.float64)) for x in pose]
    k2 = make_kernel_energy_fn(ours, "cpu", torch.float64, worklist=True)(tp, *tpose)
    k1 = make_kernel_energy_fn(ours, "cpu", torch.float64, worklist=False)(tp, *tpose)
    np.testing.assert_allclose(k2.numpy(), k1.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(k2.numpy(), ed.batch_energy(tp, *tpose).numpy(),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape,tiles,kernel", [
    ("1k4c", 107 * 26, "dfire_pairs_worklist"),
    ("1ppe", 51 * 2, "dfire_pairs"),
])
def test_worklist_rule(shape, tiles, kernel):
    """The JAX rule on the port's 32 x 128 tiles: 1k4c's 2,782 tile pairs
    take K2, 1ppe's 102 take K1."""
    if shape == "1k4c":
        params, _ = standin.membrane_system(2)
    else:
        params, _, _ = standin.toy_system(1615, 221, 2)
    n_r = -(-params.rec_coords.shape[0] // ek.R_TILE)
    n_l = -(-params.lig_coords.shape[0] // ek.L_TILE)
    assert n_r * n_l == tiles
    assert ek.use_worklist(n_r, n_l) == (kernel == "dfire_pairs_worklist")
    fn = make_kernel_energy_fn(kernel_params(params), "cpu", torch.float32)
    assert fn.kernel.__name__ == kernel
