"""DNA/PYDOCK energies of the port against the JAX package, with and
without ANM.

The dense oracle against ``energy_batch.batch_energy(xp=jnp)``; the plain
version of the elec/vdw kernel (K3) against ``elec_vdw_pairs_pallas_v2`` in
Pallas interpret mode on the same padded inputs and bits; the kernel
energy path against ``make_pallas_energy_fn(interpret=True, kernel="v2")``;
ports of the reference-free oracles of ``tests/test_energy.py``; and the
DFIRE kernel path with ligand-only ANM.  f32 tolerances are the DNA/PYDOCK
kernel tests' (tests/test_pallas.py): rtol and atol 5e-5, for the f32
summation order; interface flags are exact.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lightdock_tpu import constants as C  # noqa: E402
from lightdock_tpu.engine.energy_batch import (  # noqa: E402
    batch_energy, build_batch_params, ensure_dfire_types)
from lightdock_tpu.engine.energy_pallas import make_pallas_energy_fn  # noqa: E402
from lightdock_tpu.engine.gso_jax import device_params  # noqa: E402
from lightdock_tpu.ops import pallas_energy as pe  # noqa: E402
from lightdock_tpu.ops import quaternion as jqt  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu_torch.engine import energy_dense as ed  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    frame_center, kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import (  # noqa: E402
    from_reference, torch_params)
from lightdock_tpu_torch.ops import elec_vdw_pairs as ev  # noqa: E402
from lightdock_tpu_torch.ops.dfire_pairs import POSE_BLOCK  # noqa: E402
from lightdock_tpu_torch.ops.tiling import spatial_sort_params  # noqa: E402

TOL = dict(rtol=5e-5, atol=5e-5)
F64 = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(method="dna", num_anm=2, dtype=np.float32, g=37, n_rec=300,
            n_lig=170, seed=3, spread=40, rec_anm=True):
    """Random complex with restraints and a membrane on the receptor, so
    the interface flags and the bias are exercised; ``rec_anm=False``
    keeps ANM on the ligand alone."""
    rng = np.random.RandomState(seed)

    def model(n, k):
        kw = {}
        if method == "dfire":
            kw["atom_types"] = rng.randint(0, 168, size=n).astype(np.int32)
        else:
            kw.update(ele_charges=rng.uniform(-1, 1, n),
                      vdw_charges=rng.uniform(0, 0.5, n),
                      vdw_radii=rng.uniform(0.5, 2.5, n))
        return DockingModel(
            method=method,
            coordinates=rng.uniform(-spread, spread, size=(n, 3)),
            num_anm=k, nmodes=rng.standard_normal((k, n, 3)) * 0.2,
            membrane=np.array([0, 5], dtype=np.int64),
            active_restraints={"A.1": [1, 2], "A.2": [7]},
            passive_restraints={}, **kw)

    params = build_batch_params(
        model(n_rec, num_anm if rec_anm else 0), model(n_lig, num_anm),
        use_anm=num_anm > 0, dtype=dtype,
        potential=synthetic_potential() if method == "dfire" else None)
    t = rng.uniform(-30, 30, (g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a_r = rng.uniform(-1, 1, (g, num_anm if rec_anm else 0))
    a_l = rng.uniform(-1, 1, (g, num_anm))
    return params, [x.astype(dtype) for x in (t, q, a_r, a_l)]


def _jax(pose):
    return [jnp.asarray(x) for x in pose]


def _torch(pose):
    return [torch.as_tensor(x) for x in pose]


@pytest.mark.parametrize("method", ["dna", "pydock"])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, TOL)])
def test_dense_matches_batch_energy(method, num_anm, dtype, tol):
    params, pose = _system(method, num_anm, dtype)
    ref = batch_energy(device_params(params, dtype), *_jax(pose), xp=jnp)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tp = torch_params(from_reference(params), "cpu", tdtype)
    out = ed.batch_energy(tp, *_torch(pose))
    assert out.dtype == tdtype and out.shape == (pose[0].shape[0],)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    # Pose chunking bounds memory and keeps every score.
    chunked = ed.batch_energy_chunked(tp, *_torch(pose), chunk=8)
    np.testing.assert_allclose(chunked.numpy(), out.numpy(), **tol)


def _kernel_inputs(g, per_pose, seed=9, r_tile=32, l_tile=128):
    """Re-centred coordinates (receptor rigid or per pose), per-atom
    vectors and seeded cull bits, padded nowhere: both kernels pad them
    the same way.  Poses are clustered by chunk so that some chunk-tiles
    are far; near bits are truthful at the 10 A vdw reach."""
    params, pose = _system(g=g, spread=20)
    params = spatial_sort_params(from_reference(params), r_tile, l_tile)
    c = frame_center(params).astype(np.float32)
    rng = np.random.RandomState(seed)
    n_c = -(-g // POSE_BLOCK)
    # Chunk clusters 45 A out in random directions: the 40 A boxes of the
    # two molecules then overlap in part.
    out = rng.standard_normal((n_c, 3))
    out *= 45.0 / np.linalg.norm(out, axis=1, keepdims=True)
    t = (np.repeat(out, POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3))).astype(np.float32)
    rot = jqt.rotation_matrix(pose[1].astype(np.float64), np).astype(np.float32)
    lig = (np.einsum("gab,nb->gan", rot, params.lig_coords)
           + (t - c)[:, :, None]
           + np.einsum("gk,knc->gcn", pose[3], params.lig_nmodes)
           ).astype(np.float32)                                  # (G, 3, Nl)
    rec = (params.rec_coords - c)[None].astype(np.float32)        # (1, Nr, 3)
    if per_pose:
        rec = (rec + np.einsum("gk,knc->gnc", pose[2],
                               params.rec_nmodes)).astype(np.float32)
    n_r = -(-rec.shape[1] // r_tile)
    n_l = -(-lig.shape[2] // l_tile)
    act = (rng.rand(n_r, n_l, n_c) < 0.8).astype(np.int32)
    iface = (rng.rand(n_r, n_l, g) < 0.5).astype(np.int32)
    # Over the real poses, as the energy path's cull takes them.
    gp = n_c * POSE_BLOCK
    lp = np.pad(lig, ((0, 0), (0, 0), (0, n_l * l_tile - lig.shape[2])),
                constant_values=-1e6)
    rp = np.pad(rec, ((0, 0), (0, n_r * r_tile - rec.shape[1]), (0, 0)),
                constant_values=1e6)
    d2 = ((lp[:, None, :, :] - rp[:, :, :, None]) ** 2).sum(axis=2)
    close = np.pad(d2 < C.VDW_DIST_CUTOFF2, ((0, gp - g), (0, 0), (0, 0)))
    close = close.reshape(n_c, POSE_BLOCK, n_r, r_tile, n_l, l_tile)
    near = close.any(axis=(1, 3, 5)).transpose(1, 2, 0).astype(np.int32)
    assert 0 < (near * act).sum() < act.sum()
    atoms = [params.ele_rec, params.ele_lig, params.vdw_c_rec,
             params.vdw_c_lig, params.vdw_r_rec, params.vdw_r_lig]
    return rec, lig, atoms, act, iface, near


@pytest.mark.parametrize("g", [37, 11])
@pytest.mark.parametrize("per_pose", [False, True])
@pytest.mark.parametrize("with_near", [False, True])
def test_plain_kernel_matches_pallas(g, per_pose, with_near):
    r_tile, l_tile = 32, 128
    rec, lig, atoms, act, iface, near = _kernel_inputs(g, per_pose)
    near = near if with_near else None
    pallas = jax.jit(lambda *a: pe.elec_vdw_pairs_pallas_v2(
        *a[:10], interpret=True, r_tile=r_tile, l_tile=l_tile, need_iface=True,
        near_chunks=a[10] if len(a) > 10 else None, p_block=POSE_BLOCK))
    inputs = [rec, lig, *atoms, act, iface] + ([] if near is None else [near])
    ref = pallas(*[jnp.asarray(x) for x in inputs])
    before = ev.elec_vdw_pairs.launches
    out = ev.elec_vdw_pairs(*[torch.as_tensor(x) for x in inputs[:10]],
                            r_tile=r_tile, l_tile=l_tile,
                            near_chunks=None if near is None else torch.as_tensor(near))
    assert ev.elec_vdw_pairs.launches == before   # the CPU path launches nothing
    assert bool(torch.isfinite(out[0]).all())
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    assert np.abs(np.asarray(ref[0])).max() > 1.0
    for ours, theirs in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert out[1].sum() > 0 and out[2].sum() > 0
    # need_iface=False returns no flags and the same sums.
    raw, ifr, ifl = ev.elec_vdw_pairs_plain(
        *[torch.as_tensor(x) for x in inputs[:10]], r_tile=r_tile,
        l_tile=l_tile, need_iface=False,
        near_chunks=None if near is None else torch.as_tensor(near))
    assert ifr is None and ifl is None
    np.testing.assert_array_equal(raw.numpy(), out[0].numpy())


def _both_fns(params, cull=True):
    # jit: one compile of the interpreted kernel instead of eager tracing.
    jfn = jax.jit(make_pallas_energy_fn(params, interpret=True, cull=cull,
                                        kernel="v2"))
    kparams = kernel_params(from_reference(params))
    tfn = make_kernel_energy_fn(kparams, "cpu", torch.float32, cull=cull)
    return (jfn, device_params(params, np.float32),
            tfn, torch_params(kparams, "cpu", torch.float32))


@pytest.mark.parametrize("method", ["dna", "pydock"])
@pytest.mark.parametrize("num_anm", [0, 2])
def test_energy_fn_matches_pallas(method, num_anm):
    """Scores match the JAX kernel path, and culled equals unculled
    exactly."""
    params, pose = _system(method, num_anm)
    jfn, jp, tfn, tp = _both_fns(params)
    ref = np.asarray(jfn(jp, *_jax(pose)))
    out = tfn(tp, *_torch(pose))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    _, _, tfull, _ = _both_fns(params, cull=False)
    assert torch.equal(tfull(tp, *_torch(pose)), out)


@pytest.mark.parametrize("g", [11, 37])
def test_energy_fn_moved_skip(g):
    """Unmoved poses return their stored score exactly; moved poses match
    the ungated computation and the reference."""
    params, pose = _system("dna", 2, g=g)
    jfn, jp, tfn, tp = _both_fns(params)
    full = tfn(tp, *_torch(pose))
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


def test_energy_fn_matches_dense_f64():
    """At f64 the kernel path (plain version) and the dense oracle agree
    to rounding, receptor and ligand ANM included."""
    params, pose = _system("dna", 2, np.float64)
    params = kernel_params(from_reference(params))
    tp = torch_params(params, "cpu", torch.float64)
    tfn = make_kernel_energy_fn(params, "cpu", torch.float64)
    np.testing.assert_allclose(tfn(tp, *_torch(pose)).numpy(),
                               ed.batch_energy(tp, *_torch(pose)).numpy(), **F64)


def test_dfire_ligand_anm_matches_pallas():
    """DFIRE with ANM on the ligand alone runs K1 on per-pose ligands and
    a rigid receptor; with ANM on both sides K1 takes a per-pose receptor.
    Both match the JAX kernel path."""
    params, pose = _system("dfire", 2, rec_anm=False)
    params = ensure_dfire_types(params)
    jfn, jp, tfn, tp = _both_fns(params)
    np.testing.assert_allclose(tfn(tp, *_torch(pose)).numpy(),
                               np.asarray(jfn(jp, *_jax(pose))), **TOL)
    assert tfn.kernel_args(tp, *_torch(pose))[0][0].shape[0] == 1
    both, pose = _system("dfire", 2)
    jfn, jp, tfn, tp = _both_fns(ensure_dfire_types(both))
    assert tfn.kernel_args(tp, *_torch(pose))[0][0].shape[0] == pose[0].shape[0]
    np.testing.assert_allclose(tfn(tp, *_torch(pose)).numpy(),
                               np.asarray(jfn(jp, *_jax(pose))), **TOL)


def test_elec_vdw_micro_oracle():
    """The dense oracle vs a literal per-pair loop translation of the
    reference hot loop (src/dna.rs:471-514), at f64 (port of
    tests/test_energy.py::test_elec_vdw_micro_oracle)."""
    rng = np.random.RandomState(9)
    n_r, n_l = 17, 29

    def model(n):
        return DockingModel(
            method="dna", coordinates=rng.uniform(-15, 15, size=(n, 3)),
            num_anm=0, nmodes=np.zeros((0, n, 3)),
            membrane=np.zeros(0, dtype=np.int64), active_restraints={},
            passive_restraints={}, ele_charges=rng.uniform(-1, 1, size=n),
            vdw_charges=rng.uniform(0, 0.5, size=n),
            vdw_radii=rng.uniform(0.5, 2.5, size=n))

    rec, lig = model(n_r), model(n_l)
    params = build_batch_params(rec, lig, use_anm=False, dtype=np.float64)
    zeros = torch.zeros((1, 0), dtype=torch.float64)
    fast = float(ed.batch_energy(
        torch_params(from_reference(params), "cpu", torch.float64),
        torch.zeros((1, 3), dtype=torch.float64),
        torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64), zeros, zeros)[0])
    total_elec = total_vdw = 0.0
    for i in range(n_r):
        for j in range(n_l):
            diff = rec.coordinates[i] - lig.coordinates[j]
            d2 = float(diff @ diff)
            if d2 <= 900.0:
                e = rec.ele_charges[i] * lig.ele_charges[j] / d2
                total_elec += min(max(e, C.ELEC_MIN_CUTOFF), C.ELEC_MAX_CUTOFF)
            if d2 <= 100.0:
                ve = math.sqrt(rec.vdw_charges[i] * lig.vdw_charges[j])
                vr = rec.vdw_radii[i] + lig.vdw_radii[j]
                p6 = vr ** 6 / d2 ** 3
                total_vdw += min(ve * (p6 * p6 - 2 * p6), 1.0)
    expected = -(total_elec * 332.0 / 4.0 + total_vdw)
    assert fast == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_elec_vdw_coincident_pair(dtype):
    """d2 -> 0 clamps elec and saturates vdw; d2 == 0 gives NaN through the
    vdw inf - inf, in the dense oracle and in the kernel's plain version
    alike (port of tests/test_energy.py::test_elec_vdw_coincident_pair)."""
    def model(coords):
        n = len(coords)
        return DockingModel(
            method="dna", coordinates=np.asarray(coords, dtype=np.float64),
            num_anm=0, nmodes=np.zeros((0, n, 3)),
            membrane=np.zeros(0, dtype=np.int64), active_restraints={},
            passive_restraints={}, ele_charges=np.full(n, 0.5),
            vdw_charges=np.full(n, 0.2), vdw_radii=np.full(n, 1.5))

    one = dict(dtype=dtype)
    t, q = torch.zeros((1, 3), **one), torch.tensor([[1.0, 0, 0, 0]], **one)
    zeros = torch.zeros((1, 0), **one)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    for lig_x, expect_nan in ((1e-2, False), (0.0, True)):
        params = build_batch_params(model([[0.0, 0.0, 0.0]]),
                                    model([[lig_x, 0.0, 0.0]]),
                                    use_anm=False, dtype=np_dtype)
        tp = torch_params(from_reference(params), "cpu", dtype)
        dense = float(ed.batch_energy(tp, t, q, zeros, zeros)[0])
        raw, _, _ = ev.elec_vdw_pairs(
            tp.rec_coords[None], tp.lig_coords.T[None], tp.ele_rec, tp.ele_lig,
            tp.vdw_c_rec, tp.vdw_c_lig, tp.vdw_r_rec, tp.vdw_r_lig,
            torch.ones((1, 1, 1), dtype=torch.int32),
            torch.ones((1, 1, 1), dtype=torch.int32), r_tile=32, l_tile=128)
        kernel = -float(raw[0])
        if expect_nan:
            assert math.isnan(dense) and math.isnan(kernel)
        else:
            clamp = -(C.ELEC_MAX_CUTOFF * 332.0 / 4.0 + C.VDW_CUTOFF)
            assert dense == pytest.approx(clamp, rel=1e-6)
            assert kernel == pytest.approx(clamp, rel=1e-6)


def test_elec_vdw_pairs_refuses_bad_inputs():
    rec, lig, atoms, act, iface, near = _kernel_inputs(11, per_pose=False)
    args = [torch.as_tensor(x) for x in (rec, lig, *atoms, act, iface)]
    with pytest.raises(ValueError, match="neither rigid"):
        ev.elec_vdw_pairs(torch.zeros(3, rec.shape[1], 3), *args[1:],
                          r_tile=32, l_tile=128)
    with pytest.raises(ValueError, match="active_chunks"):
        ev.elec_vdw_pairs(*args[:8], args[8][:, :, :0], args[9],
                          r_tile=32, l_tile=128)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ev.elec_vdw_pairs(*[x.to("meta") for x in args], r_tile=32, l_tile=128)
