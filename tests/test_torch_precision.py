"""Scoring at another dtype than the swarm state, and the precision tool.

``engine.runner.mixed_precision_energy`` and
``GsoTorchRunner(energy_dtype=...)`` against ``lightdock_tpu.engine.
gso_jax``'s on the same inputs, in every energy mode (the kernels' plain
versions on the CPU, JAX's Pallas kernels in interpret mode), and
``lightdock_tpu_torch.precision_fidelity`` against
``scripts/precision_fidelity.py`` on the same runs.

Tolerances: float32 scores at ``tests/test_pallas.py``'s, rtol 5e-6 for
DFIRE and rtol/atol 5e-5 for DNA and PYDOCK (two float32 sums of the same
pair terms in another order).  Poses after the first move at 1e-9: the move
is float64 arithmetic in both packages, and it reads the scores only
through the neighbour and roulette choices, which agree.  Later steps are
not compared across packages: a float32 score moves a pose at a DFIRE bin
edge, and float32 trajectories part within 10-30 steps.
"""

import functools
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lightdock_tpu.engine import gso_jax  # noqa: E402
from lightdock_tpu.engine.energy_batch import build_batch_params  # noqa: E402
from lightdock_tpu.engine.gso_jax import GsoJaxRunner, device_params  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu.simulation import load_simulation as jax_load_simulation  # noqa: E402
from lightdock_tpu_torch import precision_fidelity as pf  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine import energy_dense, energy_kernel  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import from_reference, torch_params  # noqa: E402
from lightdock_tpu_torch.engine.runner import (GsoTorchRunner,  # noqa: E402
                                               mixed_precision_energy)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = {"dfire": dict(rtol=5e-6, atol=0.0), "dna": dict(rtol=5e-5, atol=5e-5)}
POSE_ATOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(seed, n_rec=40, n_lig=26, g=24, method="dfire", num_anm=0,
         dfire_mode="auto"):
    """(params at float64, positions (G, 7 + 2 num_anm)): a small complex
    with restraints on both sides (the interface flags and the bias run),
    random DFIRE types or charges and radii, ``num_anm`` modes a side.  The
    translations come in threes within about 0.1 A, inside the first
    vision range (0.2 A), so that the first step moves poses."""
    rng = np.random.RandomState(seed)

    def model(n):
        if method == "dfire":
            kw = dict(atom_types=rng.randint(0, 168, size=n).astype(np.int32))
        else:
            kw = dict(ele_charges=rng.uniform(-1, 1, n),
                      vdw_charges=rng.uniform(0, 0.5, n),
                      vdw_radii=rng.uniform(0.5, 2.5, n))
        return DockingModel(
            method=method, coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=num_anm, nmodes=rng.standard_normal((num_anm, n, 3)) * 0.1,
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={"A.1": [0, 1, 2], "A.2": [5, 6]},
            passive_restraints={}, **kw)

    params = build_batch_params(
        model(n_rec), model(n_lig), use_anm=num_anm > 0, dtype=np.float64,
        potential=synthetic_potential() if method == "dfire" else None,
        dfire_mode=dfire_mode)
    t = (rng.uniform(-10, 10, size=(-(-g // 3), 3)).repeat(3, axis=0)[:g]
         + rng.standard_normal((g, 3)) * 0.03)
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a = rng.uniform(-1, 1, size=(g, 2 * num_anm))
    return params, np.concatenate([t, q, a], axis=1)


def _poses(pos, num_anm):
    k = num_anm
    return [pos[:, :3], pos[:, 3:7], pos[:, 7:7 + k], pos[:, 7 + k:7 + 2 * k]]


@pytest.mark.parametrize("method,num_anm,seed", [("dfire", 0, 21), ("dna", 2, 22)])
def test_mixed_precision_energy_matches_jax(method, num_anm, seed):
    """float64 poses scored at float32 through the dense energy (chunked):
    float64 scores, equal to JAX's wrapper at the float32 tolerance."""
    params, pos = _toy(seed, method=method, num_anm=num_anm)
    poses = _poses(pos, num_anm)
    ref_fn = gso_jax.mixed_precision_energy(
        functools.partial(gso_jax.batch_energy_chunked, chunk=7),
        jnp.float64, jnp.float32)
    ref = ref_fn(device_params(params, jnp.float32),
                 *[jnp.asarray(x, jnp.float64) for x in poses])
    ours_fn = mixed_precision_energy(
        functools.partial(energy_dense.batch_energy_chunked, chunk=7),
        torch.float64, torch.float32)
    ours = ours_fn(torch_params(from_reference(params), "cpu", torch.float32),
                   *[torch.as_tensor(x, dtype=torch.float64) for x in poses])
    assert ours.dtype == torch.float64 and ref.dtype == jnp.float64
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL[method])


def test_mixed_precision_energy_identity_and_unmoved():
    """The wrapper is the function itself where the dtypes agree or no
    energy dtype is given.  Through the kernel energy (K1's plain version),
    an unmoved pose's stored float64 score comes back as
    float64(float32(prev)), as JAX's wrapper gives it, and a moved pose's
    score is the float32 run's cast up, bit for bit."""
    params, pos = _toy(23, dfire_mode="types")
    kparams = kernel_params(from_reference(params))
    fn = make_kernel_energy_fn(kparams, "cpu", torch.float32)
    assert mixed_precision_energy(fn, torch.float32, None) is fn
    assert mixed_precision_energy(fn, torch.float64, torch.float64) is fn
    assert gso_jax.mixed_precision_energy(fn, jnp.float64, None) is fn
    wrapped = mixed_precision_energy(fn, torch.float64, torch.float32)
    assert wrapped.kernel is fn.kernel
    tp = torch_params(kparams, "cpu", torch.float32)
    poses64 = [torch.as_tensor(x, dtype=torch.float64) for x in _poses(pos, 0)]
    g = pos.shape[0]
    moved = torch.as_tensor(np.arange(g) % 3 != 0)
    prev = torch.as_tensor(np.random.RandomState(4).standard_normal(g) * 10 + 1e-9)
    out = wrapped(tp, *poses64, moved=moved, prev_scoring=prev)
    assert out.dtype == torch.float64
    lost = prev.to(torch.float32).to(torch.float64)
    assert torch.equal(out[~moved], lost[~moved])
    assert not torch.equal(out[~moved], prev[~moved])     # the low bits went
    f32 = fn(tp, *[x.to(torch.float32) for x in poses64])
    assert torch.equal(out[moved], f32.to(torch.float64)[moved])

    def gate(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None):
        return jnp.where(moved, jnp.zeros_like(prev_scoring), prev_scoring)

    jax_out = gso_jax.mixed_precision_energy(gate, jnp.float64, jnp.float32)(
        None, *[jnp.asarray(x.numpy()) for x in poses64],
        moved=jnp.asarray(moved.numpy()), prev_scoring=jnp.asarray(prev.numpy()))
    np.testing.assert_array_equal(np.asarray(jax_out)[~moved.numpy()],
                                  lost[~moved].numpy())


# (port mode, JAX mode, method, ANM modes a side, DFIRE tables, dq_bf16,
#  work list forced)
RUNNER_CASES = [
    ("dense", "xla", "dfire", 0, "steps", False, False),
    ("dense", "xla", "dna", 2, "auto", False, False),
    ("kernel", "pallas", "dfire", 0, "auto", False, False),
    ("kernel", "pallas", "dfire", 2, "auto", False, True),
    ("kernel", "pallas", "dna", 2, "auto", False, False),
    ("kernel_v1", "pallas_v1", "dfire", 0, "steps", True, False),
    ("kernel_v1", "pallas_v1", "dna", 2, "auto", False, False),
]


@pytest.mark.parametrize("mode,jax_mode,method,num_anm,dfire_mode,dq_bf16,worklist",
                         RUNNER_CASES)
def test_runner_energy_dtype_matches_jax(monkeypatch, mode, jax_mode, method, num_anm,
                                         dfire_mode, dq_bf16, worklist):
    """``GsoTorchRunner(dtype=float64, energy_dtype=float32)`` on the CPU
    against ``GsoJaxRunner`` with the same dtypes, one step: step-1 scores
    at the float32 tolerance, bit-equal to the float32 runner's cast to
    float64 (the kernel gets the same float32 poses); the poses after the
    first move within 1e-9 of JAX's, the neighbour counts equal, the state
    still float64; ``dq_bf16`` reaches K4's step tables; the work list
    (K2) forced once by lowering the rule's threshold."""
    if worklist:
        monkeypatch.setattr(energy_kernel, "WORKLIST_MIN_TILES", 1)
    params, pos = _toy(31, method=method, num_anm=num_anm, dfire_mode=dfire_mode)
    kw = dict(seed=324324, use_anm=num_anm > 0, anm_rec=num_anm, anm_lig=num_anm,
              dq_bf16=dq_bf16)
    chunk = 7 if mode == "dense" else 0
    ref = GsoJaxRunner(params, pos, dtype=jnp.float64, energy_mode=jax_mode,
                       energy_dtype=jnp.float32, energy_chunk=chunk, **kw)
    ref_state, ref_outs = ref.run(1)
    port = GsoTorchRunner(from_reference(params), pos, dtype=torch.float64,
                          energy_dtype=torch.float32, device="cpu",
                          energy_mode=mode, energy_chunk=chunk, **kw)
    f32 = GsoTorchRunner(from_reference(params), pos, dtype=torch.float32,
                         device="cpu", energy_mode=mode, energy_chunk=chunk, **kw)
    if mode != "dense":
        expected = {"dfire": "dfire_pairs", "dna": "elec_vdw_pairs"}[method]
        if mode == "kernel_v1":
            expected += "_v1"
        elif worklist:
            expected += "_worklist"
        assert port.energy_fn.kernel.__name__ == expected
    if dq_bf16:
        assert port.params.dfire_dq.dtype == torch.bfloat16
        assert ref.params.dfire_dq.dtype == jnp.bfloat16
    state, outs = port.run(1)
    step1 = outs.scoring[0]
    assert step1.dtype == torch.float64
    assert all(x.dtype == torch.float64 for x in state if x.is_floating_point())
    assert torch.equal(step1, f32.run(1)[1].scoring[0].to(torch.float64))
    np.testing.assert_allclose(step1.numpy(), np.asarray(ref_outs.scoring[0]),
                               **TOL["dfire" if method == "dfire" else "dna"])
    np.testing.assert_array_equal(state.num_neighbors.numpy(),
                                  np.asarray(ref_state.num_neighbors))
    assert (state.num_neighbors > 0).any()   # the swarm moved
    assert not np.allclose(state.t.numpy(), pos[:, :3])
    for name in ("t", "q", "a_rec", "a_lig"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(ref_state, name)),
                                   rtol=0, atol=POSE_ATOL, err_msg=name)


@pytest.mark.parametrize("method,num_anm", [("dfire", 0), ("pydock", 2)])
def test_runner_f32_state_f64_energy_matches_jax(method, num_anm):
    """The other hybrid: a float32 swarm scored by the float64 dense
    energy, against JAX's at step 1 (scores float32 at the float32
    tolerance, poses after the move at float32's own resolution)."""
    params, pos = _toy(32, method=method, num_anm=num_anm)
    kw = dict(seed=324324, use_anm=num_anm > 0, anm_rec=num_anm, anm_lig=num_anm,
              energy_chunk=7)
    ref = GsoJaxRunner(params, pos, dtype=jnp.float32, energy_mode="xla",
                       energy_dtype=jnp.float64, **kw)
    ref_state, ref_outs = ref.run(1)
    port = GsoTorchRunner(from_reference(params), pos, dtype=torch.float32,
                          energy_dtype=torch.float64, device="cpu",
                          energy_mode="dense", **kw)
    assert port.params.rec_coords.dtype == torch.float64
    state, outs = port.run(1)
    assert outs.scoring.dtype == torch.float32
    np.testing.assert_allclose(outs.scoring[0].numpy(), np.asarray(ref_outs.scoring[0]),
                               **TOL["dfire" if method == "dfire" else "dna"])
    np.testing.assert_array_equal(state.num_neighbors.numpy(),
                                  np.asarray(ref_state.num_neighbors))
    np.testing.assert_allclose(state.t.numpy(), np.asarray(ref_state.t),
                               rtol=0, atol=1e-5)


@pytest.fixture
def script(monkeypatch):
    """``scripts/precision_fidelity.py`` as a module; ``sys.path``, which it
    changes at import, is restored."""
    path = list(sys.path)
    with monkeypatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            "_precision_fidelity_script", REPO / "scripts" / "precision_fidelity.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert sys.path == path
    return mod


def test_kendall_tau_matches_script(script):
    rng = np.random.RandomState(9)
    for n in (1, 2, 37, 200):
        a = np.round(rng.standard_normal(n), 1)     # ties on both sides
        b = a + np.round(rng.standard_normal(n), 1) * 0.5
        assert pf.kendall_tau(a, b) == script.kendall_tau(a, b)
        assert pf.kendall_tau(a, a) == script.kendall_tau(a, a)


def _assert_same(ours, ref, where="row"):
    """Equal ints, bools, None and keys; floats within 1e-9."""
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys(), where
        for k in ref:
            _assert_same(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert isinstance(ours, float) and abs(ours - ref) <= 1e-9, (where, ours, ref)
    else:
        assert type(ours) is type(ref) and ours == ref, (where, ours, ref)


def test_compare_runs_matches_script(tmp_path, script):
    """Parts B and C: the port's ``compare_runs`` on a float64 dense run
    and a float32 kernel run of the port (100 steps, 24 glowworms, a
    40 x 26-atom DFIRE stand-in from ``write_complex``) equals the script's
    ``compare_runs`` on the same directories with a JAX ``Simulation``
    loaded from the same files."""
    ex = tmp_path / "in"
    setup, (positions,) = standin.write_complex(ex, "dfire", 40, 26, 24)
    sim = pf.load_simulation(setup, positions, "dfire", anm_dir=ex)
    pf.run_engine(sim, tmp_path / "f64", "f64", "dense", torch.device("cpu"))
    pf.run_engine(sim, tmp_path / "f32", "f32", "kernel", torch.device("cpu"))
    ours = pf.compare_runs(tmp_path / "f64", tmp_path / "f32", sim)
    jsim = jax_load_simulation(setup, positions, "dfire", anm_dir=ex)
    ref = script.compare_runs(tmp_path / "f64", tmp_path / "f32", jsim)
    _assert_same(ours, ref)
    assert ours["first_rendered_divergence_step"] is not None


def test_precision_tool_rows(tmp_path, monkeypatch):
    """``main`` with ``--standin`` and ``--hybrids`` on the CPU (the
    stand-ins cut to 40 x 26 and 30 x 20 atoms, 24 glowworms, 20 steps):
    every row the script writes, with the script's fields under the port's
    mode names; the float64 seed control scores step 1 alike (step 1 scores
    the initial poses; the seed moves only the draws); part A's medians
    within 1e-5."""
    monkeypatch.setattr(pf, "STANDINS", {"1ppe": (40, 26, 24, 0),
                                         "1azp": (30, 20, 24, 2)})
    out = tmp_path / "p.json"
    assert pf.main(["--device", "cpu", "--standin", str(tmp_path / "in"), "--hybrids",
                    "--steps", "20", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    compared = {"horizon", "first_rendered_divergence_step", "step20"}
    expected = {}
    for name, method in (("1azp", "dna"), ("1ppe", "dfire")):
        expected[f"{name}_cpu_kernel"] = {"example", "method", "backend", "engine_f32",
                                          "energy_accuracy"} | compared
        expected[f"{name}_control_f64_seedB"] = {"example", "note"} | compared
        for label in ("f32_state_f64_energy", "f64_state_f32_energy"):
            expected[f"{name}_hybrid_{label}"] = {"example", "state_dtype", "energy_dtype",
                                                  "engine", "backend"} | compared
    assert {k: set(v) for k, v in rows.items()} == expected
    for name in ("1azp", "1ppe"):
        row = rows[f"{name}_cpu_kernel"]
        acc = row["energy_accuracy"]
        assert acc["kernel_plain"] is True
        for mode in ("dense_f32_rel_err", "kernel_f32_rel_err"):
            assert acc[mode]["median"] <= 1e-5 and acc[mode]["max"] >= acc[mode]["median"]
        assert [h["step"] for h in row["horizon"]] == [1, 10, 20]
        assert set(row["step20"]) == {
            "best_score_f64", "best_score_f32", "best_score_rel_diff", "best_pose_same",
            "top10_overlap", "kendall_tau", "n_clusters_f64", "n_clusters_f32",
            "cluster_rep_overlap"}
        ctrl = rows[f"{name}_control_f64_seedB"]
        assert ctrl["horizon"][0]["max_dscore"] == 0.0
        assert ctrl["horizon"][-1]["max_dt"] > 0.0
