"""Port energies against the JAX package on the same inputs.

The dense oracle against ``energy_batch.batch_energy(xp=jnp)``; the plain
version of the DFIRE kernel against ``dfire_pairs_pallas_v2`` in Pallas
interpret mode on the same padded inputs and bits; the kernel energy path
against ``make_pallas_energy_fn(interpret=True, kernel="v2")``.
f32 tolerances are the v2 kernel tests' (tests/test_pallas.py): rtol and
atol 5e-5, for the f32 summation order; interface flags are exact.
"""

import math

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
from lightdock_tpu.scoring import tables as score_tables  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu_torch.engine import energy_dense as ed  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    frame_center, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import (  # noqa: E402
    from_reference, torch_params)
from lightdock_tpu_torch.ops import dfire_pairs as dp  # noqa: E402
from lightdock_tpu_torch.ops.tiling import spatial_sort_params  # noqa: E402

TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(dtype=np.float32, dfire_mode="steps", restraints=True, g=37,
            n_rec=300, n_lig=170, seed=3, spread=40):
    rng = np.random.RandomState(seed)

    def model(n):
        return DockingModel(
            method="dfire",
            coordinates=rng.uniform(-spread, spread, size=(n, 3)),
            num_anm=0, nmodes=np.zeros((0, n, 3)),
            membrane=(np.array([0, 5], dtype=np.int64) if restraints
                      else np.zeros(0, dtype=np.int64)),
            active_restraints=({"A.1": [1, 2], "A.2": [7]} if restraints else {}),
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32))

    params = build_batch_params(model(n_rec), model(n_lig), use_anm=False,
                                dtype=dtype, potential=synthetic_potential(),
                                dfire_mode=dfire_mode)
    t = rng.uniform(-30, 30, (g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a = np.zeros((g, 0))
    return params, [x.astype(dtype) for x in (t, q, a, a)]


def _jax(pose):
    return [jnp.asarray(x) for x in pose]


def _torch(pose):
    return [torch.as_tensor(x) for x in pose]


@pytest.mark.parametrize("dtype,dfire_mode,tol", [
    (np.float64, "gather", dict(rtol=1e-10, atol=1e-10)),
    (np.float64, "steps", dict(rtol=1e-10, atol=1e-10)),
    (np.float32, "steps", TOL),
])
def test_dense_matches_batch_energy(dtype, dfire_mode, tol):
    params, pose = _system(dtype, dfire_mode)
    ref = batch_energy(device_params(params, dtype), *_jax(pose), xp=jnp)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    out = ed.batch_energy(torch_params(from_reference(params), "cpu", tdtype),
                          *_torch(pose))
    assert out.dtype == tdtype and out.shape == (pose[0].shape[0],)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)


def _kernel_inputs(g=37, seed=9, r_tile=32, l_tile=128, p_block=dp.POSE_BLOCK):
    """Re-centred coordinates, type tables and seeded cull bits, padded
    nowhere: both kernels pad them the same way."""
    params, pose = _system(g=g)
    params = spatial_sort_params(from_reference(ensure_dfire_types(params)),
                                 r_tile, l_tile)
    c = frame_center(params).astype(np.float32)
    rng = np.random.RandomState(seed)
    # Poses clustered by chunk, so some chunk-tiles are far and some near.
    n_c = -(-g // p_block)
    t = (np.repeat(rng.uniform(-45, 45, (n_c, 3)), p_block, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3))).astype(np.float32)
    q = pose[1]
    rot = jqt.rotation_matrix(q.astype(np.float64), np).astype(np.float32)
    lig = (np.einsum("gab,nb->gan", rot, params.lig_coords)
           + (t - c)[:, :, None]).astype(np.float32)           # (G, 3, Nl)
    rec = (params.rec_coords - c)[None].astype(np.float32)       # (1, Nr, 3)
    n_r = -(-rec.shape[1] // r_tile)
    n_l = -(-lig.shape[2] // l_tile)
    act = (rng.rand(n_r, n_l, n_c) < 0.8).astype(np.int32)
    iface = (rng.rand(n_r, n_l, g) < 0.5).astype(np.int32)
    # Truthful near bits: 1 where a chunk-tile has a pair nearer than the
    # far split (the kernels assume the bit never lies).
    thr = tuple(float(x) for x in params.dfire_thresholds)
    split, live = pe.dfire_far_split(thr)
    gp = n_c * p_block
    lp = np.pad(lig, ((0, gp - g), (0, 0), (0, n_l * l_tile - lig.shape[2])),
                constant_values=1e6)
    rp = np.pad(rec[0], ((0, n_r * r_tile - rec.shape[1]), (0, 0)),
                constant_values=1e6)
    d2 = ((lp[:, None, :, :] - rp[None, :, :, None]) ** 2).sum(axis=2)
    close = (d2 < thr[live[split]]).reshape(n_c, p_block, n_r, r_tile, n_l, l_tile)
    near = close.any(axis=(1, 3, 5)).transpose(1, 2, 0).astype(np.int32)
    assert 0 < near.sum() < near.size
    return params, rec, lig, act, iface, near


@pytest.mark.parametrize("g", [37, 11])
@pytest.mark.parametrize("with_near", [False, True])
def test_plain_kernel_matches_pallas(g, with_near):
    r_tile, l_tile, p_block = 32, 128, dp.POSE_BLOCK
    params, rec, lig, act, iface, near = _kernel_inputs(g=g)
    near = near if with_near else None
    thr = tuple(float(x) for x in params.dfire_thresholds)
    dparams = device_params(params, np.float32)
    pallas = jax.jit(lambda *a: pe.dfire_pairs_pallas_v2(
        *a[:4], thr, *a[4:6], interpret=True, r_tile=r_tile, l_tile=l_tile,
        need_iface=True, near_chunks=a[6] if len(a) > 6 else None,
        p_block=p_block))
    ref = pallas(jnp.asarray(rec), jnp.asarray(lig), dparams.dfire_rec_half,
                 dparams.dfire_lig_onehot, jnp.asarray(act), jnp.asarray(iface),
                 *([] if near is None else [jnp.asarray(near)]))
    tp = torch_params(params, "cpu", torch.float32)
    tables = dp.dfire_tables(tp.dfire_rec_half, tp.dfire_lig_onehot, thr,
                             r_tile, l_tile)
    before = dp.dfire_pairs.launches
    out = dp.dfire_pairs(torch.as_tensor(rec), torch.as_tensor(lig), tables,
                         torch.as_tensor(act), torch.as_tensor(iface),
                         r_tile=r_tile, l_tile=l_tile,
                         near_chunks=None if near is None else torch.as_tensor(near))
    assert dp.dfire_pairs.launches == before   # the CPU path launches nothing
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    assert np.abs(np.asarray(ref[0])).max() > 1.0
    for ours, theirs in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert out[1].sum() > 0 and out[2].sum() > 0
    # need_iface=False returns no flags and the same sums.
    raw, ifr, ifl = dp.dfire_pairs_plain(
        torch.as_tensor(rec), torch.as_tensor(lig), tables, torch.as_tensor(act),
        torch.as_tensor(iface), r_tile=r_tile, l_tile=l_tile, need_iface=False)
    assert ifr is None and ifl is None
    np.testing.assert_array_equal(raw.numpy(), out[0].numpy())


def test_dfire_tables_are_the_cumulative_potential():
    """cum[rec_type_i, type_j, k] rebuilds the step tables' cumulative sum
    exactly, and padded receptor and ligand atoms read a zero row and a
    zero column."""
    params, _ = _system()
    params = ensure_dfire_types(params)
    tp = torch_params(from_reference(params), "cpu", torch.float32)
    tables = dp.dfire_tables(tp.dfire_rec_half, tp.dfire_lig_onehot,
                             params.dfire_thresholds, 32, 128)
    nr, nl = params.rec_coords.shape[0], params.lig_coords.shape[0]
    k = len(tables.thresholds)
    cum_dq = np.cumsum(params.dfire_dq.astype(np.float32), axis=0,
                       dtype=np.float32)                      # (K, Nr, Nl)
    rt = tables.rec_type.numpy().astype(np.int64)
    lt = tables.lig_type.numpy().astype(np.int64)
    got = tables.cum.numpy()[rt[:nr]][:, lt[:nl], :k]        # (Nr, Nl, K)
    np.testing.assert_array_equal(got.transpose(2, 0, 1), cum_dq)
    assert (rt[nr:] == tables.cum.shape[0] - 1).all()
    assert (lt[nl:] == tables.cum.shape[1] - 1).all()
    assert not tables.cum[:, -1].any() and not tables.cum[-1].any()
    assert tables.cum.shape[0] <= 170   # one row a receptor type, not an atom


def _both_fns(params, cull=True):
    params = ensure_dfire_types(params)
    # jit: one compile of the interpreted kernel instead of eager tracing.
    jfn = jax.jit(make_pallas_energy_fn(params, interpret=True, cull=cull,
                                        kernel="v2"))
    ours = from_reference(params)
    tfn = make_kernel_energy_fn(ours, "cpu", torch.float32, cull=cull)
    return (jfn, device_params(params, np.float32),
            tfn, torch_params(ours, "cpu", torch.float32))


def test_energy_fn_matches_pallas_far_bits():
    """The production configuration (far bits on): scores match, and
    culled equals unculled exactly."""
    params, pose = _system()
    jfn, jp, tfn, tp = _both_fns(params)
    ref = np.asarray(jfn(jp, *_jax(pose)))
    out = tfn(tp, *_torch(pose))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    _, _, tfull, _ = _both_fns(params, cull=False)
    assert torch.equal(tfull(tp, *_torch(pose)), out)


@pytest.mark.parametrize("g", [3, 11])
def test_energy_fn_odd_pose_count(g):
    params, pose = _system()
    pose = [x[:g] for x in pose]
    jfn, jp, tfn, tp = _both_fns(params)
    out = tfn(tp, *_torch(pose))
    assert out.shape == (g,)
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(jp, *_jax(pose))), **TOL)


def test_energy_fn_moved_skip():
    """Unmoved poses return their stored score exactly; moved poses match
    the ungated computation and the reference."""
    params, pose = _system()
    jfn, jp, tfn, tp = _both_fns(params)
    full = tfn(tp, *_torch(pose))
    g = full.shape[0]
    rng = np.random.RandomState(11)
    moved = rng.rand(g) < 0.6
    prev = rng.uniform(-5, 5, g).astype(np.float32)
    gated = tfn(tp, *_torch(pose), moved=torch.as_tensor(moved),
                prev_scoring=torch.as_tensor(prev)).numpy()
    ref = np.asarray(jfn(jp, *_jax(pose), moved=jnp.asarray(moved),
                         prev_scoring=jnp.asarray(prev)))
    np.testing.assert_array_equal(gated[~moved], prev[~moved])
    np.testing.assert_array_equal(gated[moved], full.numpy()[moved])
    np.testing.assert_allclose(gated, ref, **TOL)
    allprev = tfn(tp, *_torch(pose), moved=torch.zeros(g, dtype=torch.bool),
                  prev_scoring=torch.as_tensor(prev))
    np.testing.assert_array_equal(allprev.numpy(), prev)


def test_energy_fn_no_bias_system():
    """No restraints and no membrane: no interface work, no bias."""
    params, pose = _system(restraints=False, g=9)
    jfn, jp, tfn, tp = _both_fns(params)
    np.testing.assert_allclose(tfn(tp, *_torch(pose)).numpy(),
                               np.asarray(jfn(jp, *_jax(pose))), **TOL)


def test_energy_fn_matches_dense_f64():
    """At f64 the kernel path (plain version) and the dense oracle agree
    to rounding."""
    params, pose = _system(np.float64, "gather")
    params = from_reference(ensure_dfire_types(params))
    tp = torch_params(params, "cpu", torch.float64)
    tfn = make_kernel_energy_fn(params, "cpu", torch.float64)
    np.testing.assert_allclose(tfn(tp, *_torch(pose)).numpy(),
                               ed.batch_energy(tp, *_torch(pose)).numpy(),
                               rtol=1e-10, atol=1e-10)


def test_kernel_path_refuses_what_it_does_not_run():
    """The v2 kernels for DFIRE without the type-indexed tables, the work
    list for another method, and a device other than cpu or cuda are
    refused; DFIRE with the step tables alone resolves to the v1 kernel K4
    (``resolve_kernel``, as in JAX); DFIRE with receptor ANM runs through
    K1."""
    import dataclasses

    from lightdock_tpu_torch.ops.dfire_pairs_v1 import dfire_pairs_v1
    params, _ = _system()
    ours = from_reference(params)
    with pytest.raises(ValueError, match="type-indexed"):
        make_kernel_energy_fn(ours, "cpu", kernel="v2")
    assert make_kernel_energy_fn(ours, "cpu").kernel is dfire_pairs_v1
    anm = dataclasses.replace(from_reference(ensure_dfire_types(params)),
                              use_anm=True,
                              rec_nmodes=np.ones((2, 300, 3), np.float32))
    assert make_kernel_energy_fn(anm, "cpu").kernel is dp.dfire_pairs
    dna = dataclasses.replace(anm, method="dna")
    with pytest.raises(ValueError, match="DFIRE only"):
        make_kernel_energy_fn(dna, "cpu", worklist=True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        dp.dfire_pairs(torch.zeros(1, 8, 3, device="meta"),
                       torch.zeros(2, 3, 8, device="meta"), None, None, None,
                       r_tile=32, l_tile=128)


@pytest.mark.parametrize("dfire_mode", ["gather", "steps"])
def test_dfire_binning_micro_oracle(dfire_mode):
    """The dense DFIRE oracle, gather and step forms, vs a literal per-pair
    loop translation of the reference hot loop (src/dfire.rs:325-347) at
    f64 (port of tests/test_energy.py::test_dfire_binning_micro_oracle):
    the `d as usize` truncation, the DIST_TO_BINS lookup and the bin spill
    past the 20-entry stride."""
    rng = np.random.RandomState(42)

    def model(n):
        return DockingModel(
            method="dfire", coordinates=rng.uniform(-12, 12, size=(n, 3)),
            num_anm=0, nmodes=np.zeros((0, n, 3)),
            membrane=np.zeros(0, dtype=np.int64), active_restraints={},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32))

    rec, lig = model(23), model(31)
    pot = synthetic_potential()
    d2b = score_tables.dfire_tables()["dist_to_bins"]
    params = build_batch_params(rec, lig, use_anm=False, dtype=np.float64,
                                potential=pot, dfire_mode=dfire_mode)
    one = dict(dtype=torch.float64)
    zeros = torch.zeros((1, 0), **one)
    fast = float(ed.batch_energy(torch_params(from_reference(params), "cpu",
                                              torch.float64),
                                 torch.zeros((1, 3), **one),
                                 torch.tensor([[1.0, 0, 0, 0]], **one),
                                 zeros, zeros)[0])
    score = 0.0
    for i in range(rec.num_atoms):
        for j in range(lig.num_atoms):
            diff = rec.coordinates[i] - lig.coordinates[j]
            dist2 = float(diff @ diff)
            if dist2 <= 225.0:
                d = math.sqrt(dist2) * 2.0 - 1.0
                bin_ = d2b[max(0, int(d))] - 1
                score += pot[rec.atom_types[i] * 169 * 20 + lig.atom_types[j] * 20 + bin_]
    assert fast == pytest.approx((score * 0.0157 - 4.7) * -1.0, rel=1e-12)
