"""The v1 kernels K4 and K5 and the v1 energy path against the JAX package.

The plain version of K4 against ``dfire_pairs_pallas`` and that of K5
against ``elec_vdw_pairs_pallas``, both in Pallas interpret mode on the
same inputs and per-pose bits, rigid and per-pose receptor; the port's v1
energy path against ``make_pallas_energy_fn(kernel="v1", interpret=True)``
with the cull on and off and the moved gate; the bf16 step tables; the
pose chunking; ``resolve_kernel``.  Tolerances are tests/test_pallas.py's:
rtol 5e-6 for DFIRE, rtol and atol 5e-5 for DNA and PYDOCK, elementwise;
interface flags exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lightdock_tpu.engine import energy_pallas as jep  # noqa: E402
from lightdock_tpu.engine.energy_batch import (  # noqa: E402
    build_batch_params, ensure_dfire_types)
from lightdock_tpu.engine.gso_jax import device_params  # noqa: E402
from lightdock_tpu.ops import pallas_energy as pe  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu_torch import constants as C  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    kernel_params, make_kernel_energy_fn, pose_chunked_energy, resolve_kernel)
from lightdock_tpu_torch.engine.params import (  # noqa: E402
    from_reference, torch_params)
from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4  # noqa: E402
from lightdock_tpu_torch.ops import elec_vdw_pairs_v1 as k5  # noqa: E402

TOL = {"dfire": (5e-6, 0.0), "dna": (5e-5, 5e-5), "pydock": (5e-5, 5e-5)}
R_TILE, L_TILE = 32, 128


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(method, n_rec=300, n_lig=170, num_anm=2, seed=3, spread=40,
            restraints=True, g=37):
    """tests/test_pallas.py::_system: the same draws, f32, the step
    tables for DFIRE."""
    rng = np.random.RandomState(seed)

    def model(n):
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
            num_anm=num_anm,
            nmodes=rng.standard_normal((num_anm, n, 3)) * 0.2,
            membrane=(np.array([0, 5], dtype=np.int64) if restraints
                      else np.zeros(0, dtype=np.int64)),
            active_restraints=({"A.1": [1, 2], "A.2": [7]} if restraints else {}),
            passive_restraints={},
            **kw)

    params = build_batch_params(
        model(n_rec), model(n_lig), use_anm=num_anm > 0, dtype=np.float32,
        potential=synthetic_potential() if method == "dfire" else None,
        dfire_mode="steps")
    t = rng.uniform(-30, 30, (g, 3)).astype(np.float32)
    q = rng.standard_normal((g, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a_r = rng.uniform(-1, 1, (g, num_anm)).astype(np.float32)
    a_l = rng.uniform(-1, 1, (g, num_anm)).astype(np.float32)
    return params, [t, q, a_r, a_l]


def _jax(pose):
    return [jnp.asarray(x) for x in pose]


def _torch(pose):
    return [torch.as_tensor(x) for x in pose]


def _kernel_inputs(method, num_anm, seed=9):
    """The v1 kernel's inputs from the port's energy path (cull off), with
    seeded per-pose bits."""
    params, pose = _system(method, num_anm=num_anm)
    ours = kernel_params(from_reference(params), "v1")
    fn = make_kernel_energy_fn(ours, "cpu", kernel="v1", cull=False)
    args, kwargs = fn.kernel_args(torch_params(ours, "cpu", torch.float32),
                                  *_torch(pose))
    rng = np.random.RandomState(seed)
    shape = tuple(args[-1].shape)
    act = torch.as_tensor((rng.rand(*shape) < 0.8).astype(np.int32))
    iface = torch.as_tensor((rng.rand(*shape) < 0.5).astype(np.int32))
    assert args[0].shape[0] == (pose[0].shape[0] if num_anm else 1)
    return args[:-2] + (act, iface), kwargs


def _assert_close(method, ours, ref, raw=False):
    """Scores (raw sums after the affine finish of
    ``energy_dense.finalize_raw`` when ``raw``) at test_pallas.py's
    tolerances, elementwise."""
    def score(x):
        x = np.asarray(x, np.float64)
        if not raw:
            return x
        return (x * C.DFIRE_SCALE - C.DFIRE_OFFSET) * -1.0 if method == "dfire" else -x

    rtol, atol = TOL[method]
    np.testing.assert_allclose(score(ours), score(ref), rtol=rtol, atol=atol)


def _check_flags(ours, theirs):
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours[1].sum() > 0 and ours[2].sum() > 0


@pytest.mark.parametrize("num_anm", [0, 2])
def test_plain_k4_matches_pallas(num_anm):
    """Plain K4 against ``dfire_pairs_pallas`` (interpret mode): a rigid
    receptor (broadcast for the Pallas kernel, as its energy path does) and
    a per-pose one."""
    args, kwargs = _kernel_inputs("dfire", num_anm)
    rec, lig, dq, thr, act, iface = args
    g = lig.shape[0]
    run = jax.jit(lambda *a: pe.dfire_pairs_pallas(
        *a[:3], thr, *a[3:], interpret=True, r_tile=R_TILE, l_tile=L_TILE))
    ref = run(jnp.asarray(rec.expand(g, -1, -1).numpy()), jnp.asarray(lig.numpy()),
              jnp.asarray(dq.numpy()), jnp.asarray(act.numpy()),
              jnp.asarray(iface.numpy()))
    before = k4.dfire_pairs_v1.launches
    out = k4.dfire_pairs_v1(*args, **kwargs)
    assert k4.dfire_pairs_v1.launches == before   # the CPU path launches nothing
    _assert_close("dfire", out[0].numpy(), ref[0], raw=True)
    assert np.abs(np.asarray(ref[0])).max() > 1.0
    _check_flags(out, ref)
    raw, ifr, ifl = k4.dfire_pairs_v1_plain(*args, **dict(kwargs, need_iface=False))
    assert ifr is None and ifl is None
    np.testing.assert_array_equal(raw.numpy(), out[0].numpy())


@pytest.mark.parametrize("method,num_anm", [("dna", 0), ("dna", 2), ("pydock", 2)])
def test_plain_k5_matches_pallas(method, num_anm):
    """Plain K5 against ``elec_vdw_pairs_pallas`` (interpret mode), rigid
    and per-pose receptor."""
    args, kwargs = _kernel_inputs(method, num_anm)
    rec, lig = args[:2]
    g = lig.shape[0]
    run = jax.jit(lambda *a: pe.elec_vdw_pairs_pallas(
        *a, interpret=True, r_tile=R_TILE, l_tile=L_TILE))
    ref = run(jnp.asarray(rec.expand(g, -1, -1).numpy()),
              *(jnp.asarray(x.numpy()) for x in args[1:]))
    out = k5.elec_vdw_pairs_v1(*args, **kwargs)
    _assert_close(method, out[0].numpy(), ref[0], raw=True)
    _check_flags(out, ref)
    raw, ifr, ifl = k5.elec_vdw_pairs_v1_plain(*args, **dict(kwargs, need_iface=False))
    assert ifr is None and ifl is None
    np.testing.assert_array_equal(raw.numpy(), out[0].numpy())


def _both_fns(params, cull=True):
    jfn = jax.jit(jep.make_pallas_energy_fn(params, interpret=True, cull=cull,
                                            kernel="v1"))
    ours = kernel_params(from_reference(params), "v1")
    tfn = make_kernel_energy_fn(ours, "cpu", torch.float32, cull=cull, kernel="v1")
    return (jfn, device_params(params, np.float32),
            tfn, torch_params(ours, "cpu", torch.float32))


@pytest.mark.parametrize("method,num_anm", [("dfire", 0), ("dfire", 2), ("dna", 2)])
def test_v1_energy_fn_matches_pallas(method, num_anm):
    """The port's v1 energy path against JAX's, cull on and off, and with
    the moved gate: unmoved poses keep their stored score exactly."""
    params, pose = _system(method, num_anm=num_anm)
    jfn, jp, tfn, tp = _both_fns(params)
    assert tfn.kernel is (k4.dfire_pairs_v1 if method == "dfire" else k5.elec_vdw_pairs_v1)
    ref = np.asarray(jfn(jp, *_jax(pose)))
    out = tfn(tp, *_torch(pose))
    _assert_close(method, out.numpy(), ref)
    _, _, tfull, _ = _both_fns(params, cull=False)
    _assert_close(method, tfull(tp, *_torch(pose)).numpy(), ref)
    g = ref.shape[0]
    rng = np.random.RandomState(11)
    moved = rng.rand(g) < 0.6
    prev = rng.uniform(-5, 5, g).astype(np.float32)
    gated = tfn(tp, *_torch(pose), moved=torch.as_tensor(moved),
                prev_scoring=torch.as_tensor(prev)).numpy()
    jgated = np.asarray(jfn(jp, *_jax(pose), moved=jnp.asarray(moved),
                            prev_scoring=jnp.asarray(prev)))
    np.testing.assert_array_equal(gated[~moved], prev[~moved])
    np.testing.assert_array_equal(gated[moved], out.numpy()[moved])
    _assert_close(method, gated, jgated)


def test_culling_is_conservative():
    """v1 culled and unculled paths agree exactly: every culled tile has
    provably zero contribution."""
    params, pose = _system("dfire")
    _, _, tfn, tp = _both_fns(params)
    _, _, tfull, _ = _both_fns(params, cull=False)
    assert torch.equal(tfn(tp, *_torch(pose)), tfull(tp, *_torch(pose)))


def test_pallas_no_bias_system():
    """No restraints and no membrane: the v1 path does no interface work
    (the kernel returns no flags) and matches JAX's v1 path."""
    params, pose = _system("dfire", num_anm=0, restraints=False, g=9, seed=5)
    jfn, jp, tfn, tp = _both_fns(params)
    args, kwargs = tfn.kernel_args(tp, *_torch(pose))
    assert kwargs["need_iface"] is False
    assert tfn.kernel(*args, **kwargs)[1] is None
    _assert_close("dfire", tfn(tp, *_torch(pose)).numpy(), jfn(jp, *_jax(pose)))


def test_bf16_dq_mode_close():
    """Step tables stored in bfloat16: the port's path matches JAX's bf16
    path (the same table values, upcast before each add) and stays within
    bfloat16 mantissa error of the float32 path."""
    params, pose = _system("dfire")
    jfn, jp, tfn, tp = _both_fns(params)
    jp16 = dataclasses.replace(jp, dfire_dq=jnp.asarray(jp.dfire_dq, jnp.bfloat16))
    tp16 = dataclasses.replace(tp, dfire_dq=tp.dfire_dq.to(torch.bfloat16))
    out16 = tfn(tp16, *_torch(pose))
    _assert_close("dfire", out16.numpy(), jfn(jp16, *_jax(pose)))
    base = tfn(tp, *_torch(pose))
    assert not torch.equal(out16, base)
    assert float(((out16 - base) / base).abs().max()) < 0.05


def test_pose_chunked_energy_matches_unchunked():
    """37 poses at max_chunk=16 go as 3 balanced chunks with padding, gated
    and ungated (port of the JAX test, on the v2 path it uses)."""
    params, pose = _system("dfire", num_anm=2)
    ours = kernel_params(from_reference(ensure_dfire_types(params)))
    tp = torch_params(ours, "cpu", torch.float32)
    fn = make_kernel_energy_fn(ours, "cpu", torch.float32)
    calls = []

    def counted(*a, **k):
        calls.append(a[1].shape[0])
        return fn(*a, **k)

    chunked = pose_chunked_energy(counted, max_chunk=16)
    full = fn(tp, *_torch(pose)).numpy()
    out = chunked(tp, *_torch(pose)).numpy()
    assert calls == [16, 16, 16]
    np.testing.assert_allclose(out, full, rtol=3e-5)
    g = full.shape[0]
    rng = np.random.RandomState(11)
    moved = rng.rand(g) < 0.6
    prev = rng.uniform(-5, 5, g).astype(np.float32)
    gated = chunked(tp, *_torch(pose), moved=torch.as_tensor(moved),
                    prev_scoring=torch.as_tensor(prev)).numpy()
    np.testing.assert_array_equal(gated[~moved], prev[~moved])
    np.testing.assert_allclose(gated[moved], full[moved], rtol=3e-5)
    assert pose_chunked_energy(fn, None)(tp, *_torch(pose)).shape == (g,)


def test_resolve_kernel():
    """The copy of ``resolve_kernel`` agrees with the original, and the
    energy path refuses what it cannot run."""
    dfire, _ = _system("dfire", n_rec=40, n_lig=30)
    dna, _ = _system("dna", n_rec=40, n_lig=30)
    cases = [(dfire, "auto"), (ensure_dfire_types(dfire), "auto"), (dna, "auto"),
             (dna, "v1"), (dfire, "v2")]
    for p, kernel in cases:
        assert resolve_kernel(from_reference(p), kernel) == jep.resolve_kernel(p, kernel)
    typed = dataclasses.replace(from_reference(ensure_dfire_types(dfire)), dfire_dq=None)
    with pytest.raises(ValueError, match="step tables"):
        make_kernel_energy_fn(typed, "cpu", kernel="v1")
    with pytest.raises(ValueError, match="DFIRE only"):
        make_kernel_energy_fn(from_reference(dfire), "cpu", kernel="v1", worklist=True)
    with pytest.raises(ValueError, match="kernel must be"):
        make_kernel_energy_fn(from_reference(dna), "cpu", kernel="v3")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k4.dfire_pairs_v1(torch.zeros(1, 8, 3, device="meta"),
                          torch.zeros(2, 3, 8, device="meta"), None, (), None,
                          None, r_tile=32, l_tile=128)


def test_step_tables_upload_contiguous():
    """The spatial sort leaves the (K, Nr, Nl) step tables a strided view;
    ``torch_params`` uploads them contiguous, so K4 reads them as they lie,
    and K4's launch refuses a strided table rather than copy it each call
    (it raises before it builds or touches a card)."""
    params, pose = _system("dfire", num_anm=0)
    ours = kernel_params(from_reference(params), "v1")
    assert not ours.dfire_dq.flags["C_CONTIGUOUS"]
    tp = torch_params(ours, "cpu", torch.float32)
    assert tp.dfire_dq.is_contiguous()
    assert torch.equal(tp.dfire_dq, torch.as_tensor(ours.dfire_dq))
    args, kwargs = _kernel_inputs("dfire", 0)
    strided = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k4._launch(args[0], args[1], strided, *args[3:], kwargs["r_tile"],
                   kwargs["l_tile"], kwargs["need_iface"])
