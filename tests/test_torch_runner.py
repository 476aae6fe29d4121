"""GsoTorchRunner against GsoJaxRunner, and its own run/resume contracts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lightdock_tpu.engine.energy_batch import build_batch_params  # noqa: E402
from lightdock_tpu.engine.gso_jax import GsoJaxRunner  # noqa: E402
from lightdock_tpu.scoring.models import DockingModel  # noqa: E402
from lightdock_tpu.scoring.potentials import synthetic_potential  # noqa: E402
from lightdock_tpu_torch.engine import energy_kernel  # noqa: E402
from lightdock_tpu_torch.engine.gso import SwarmState  # noqa: E402
from lightdock_tpu_torch.engine.params import from_reference  # noqa: E402
from lightdock_tpu_torch.engine.runner import GsoTorchRunner  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(seed, n_rec=40, n_lig=26, g=24, dtype=np.float64, method="dfire",
         num_anm=0, dfire_mode="auto"):
    """A small system with restraints on both sides, so the interface
    flags and the bias are exercised; DNA systems carry random charges,
    vdw energies and radii, and ``num_anm`` modes on each side."""
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
        model(n_rec), model(n_lig), use_anm=num_anm > 0, dtype=dtype,
        potential=synthetic_potential() if method == "dfire" else None,
        dfire_mode=dfire_mode)
    t = rng.uniform(-10, 10, size=(g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a = rng.uniform(-1, 1, size=(g, 2 * num_anm))
    return params, np.concatenate([t, q, a], axis=1)


def test_runner_matches_jax_runner_text(tmp_path):
    """f64 on CPU: the port renders gso_1.out and gso_10.out text-identical
    to GsoJaxRunner on the XLA path."""
    params, pos = _toy(11)
    ref = GsoJaxRunner(params, pos, seed=324324, use_anm=False, anm_rec=0,
                       anm_lig=0, output_directory=str(tmp_path / "jax"),
                       dtype=jnp.float64, energy_mode="xla")
    ref.run(10)
    port = GsoTorchRunner(from_reference(params), pos, seed=324324, use_anm=False, anm_rec=0,
                          anm_lig=0, output_directory=str(tmp_path / "torch"),
                          dtype=torch.float64, device="cpu")
    final, outs = port.run(10)
    assert outs.scoring.shape == (10, 24)
    assert (final.num_neighbors > 0).any()   # the swarm moved
    for step in (1, 10):
        a = (tmp_path / "jax" / f"gso_{step}.out").read_text()
        b = (tmp_path / "torch" / f"gso_{step}.out").read_text()
        assert a == b, f"gso_{step}.out differs"


def test_run_segmented_matches_run(tmp_path):
    params, pos = _toy(8, dtype=np.float32)
    mono = GsoTorchRunner(from_reference(params), pos, seed=11, use_anm=False, anm_rec=0,
                          anm_lig=0, output_directory=str(tmp_path / "mono"),
                          device="cpu")
    mono_final, _ = mono.run(20)
    seg = GsoTorchRunner(from_reference(params), pos, seed=11, use_anm=False, anm_rec=0,
                         anm_lig=0, output_directory=str(tmp_path / "seg"),
                         device="cpu")
    seg_final, _ = seg.run_segmented(20, 7)   # deliberately misaligned
    for a, b in zip(seg_final, mono_final):
        assert torch.equal(a, b)
    for step in (1, 10, 20):
        assert ((tmp_path / "mono" / f"gso_{step}.out").read_text()
                == (tmp_path / "seg" / f"gso_{step}.out").read_text())
    # reset rewinds to the initial swarm: the rerun is identical.
    mono.reset()
    again, _ = mono.run(20)
    for a, b in zip(again, mono_final):
        assert torch.equal(a, b)


def test_runner_matches_jax_runner_text_dna_anm(tmp_path):
    """f64 on CPU, DNA scoring with two ANM modes on each side: the port
    renders gso_1.out and gso_10.out text-identical to GsoJaxRunner on the
    XLA path, ANM columns included."""
    params, pos = _toy(12, method="dna", num_anm=2)
    ref = GsoJaxRunner(params, pos, seed=324324, use_anm=True, anm_rec=2,
                       anm_lig=2, output_directory=str(tmp_path / "jax"),
                       dtype=jnp.float64, energy_mode="xla")
    ref.run(10)
    port = GsoTorchRunner(from_reference(params), pos, seed=324324, use_anm=True, anm_rec=2,
                          anm_lig=2, output_directory=str(tmp_path / "torch"),
                          dtype=torch.float64, device="cpu")
    final, outs = port.run(10)
    assert outs.a_rec.shape == (10, 24, 2) and outs.a_lig.shape == (10, 24, 2)
    assert not torch.equal(final.a_rec, torch.as_tensor(pos[:, 7:9]))  # modes moved
    for step in (1, 10):
        a = (tmp_path / "jax" / f"gso_{step}.out").read_text()
        b = (tmp_path / "torch" / f"gso_{step}.out").read_text()
        assert len(a.splitlines()[1].split()) == len(b.splitlines()[1].split())
        assert a == b, f"gso_{step}.out differs"


def test_sidecar_resume_is_bit_exact_dna_anm(tmp_path):
    params, pos = _toy(6, dtype=np.float32, method="pydock", num_anm=2)
    kw = dict(seed=4, use_anm=True, anm_rec=2, anm_lig=2, device="cpu")
    full = GsoTorchRunner(from_reference(params), pos, output_directory=str(tmp_path / "full"), **kw)
    full_final, _ = full.run(20)
    resumed = GsoTorchRunner(from_reference(params), pos, output_directory=str(tmp_path / "res"), **kw)
    resumed.load_snapshot(tmp_path / "full" / "gso_10.out")
    res_final, _ = resumed.run(20)
    for name, a, b in zip(SwarmState._fields, res_final, full_final):
        assert torch.equal(a, b), name
    assert ((tmp_path / "full" / "gso_20.out").read_text()
            == (tmp_path / "res" / "gso_20.out").read_text())


def test_sidecar_resume_is_bit_exact(tmp_path):
    params, pos = _toy(5, dtype=np.float32)
    full = GsoTorchRunner(from_reference(params), pos, seed=3, use_anm=False, anm_rec=0,
                          anm_lig=0, output_directory=str(tmp_path / "full"),
                          device="cpu")
    full_final, _ = full.run(20)
    resumed = GsoTorchRunner(from_reference(params), pos, seed=3, use_anm=False, anm_rec=0,
                             anm_lig=0, output_directory=str(tmp_path / "res"),
                             device="cpu")
    resumed.load_snapshot(tmp_path / "full" / "gso_10.out")
    assert resumed._start_step == 10
    res_final, _ = resumed.run(20)
    for name, a, b in zip(SwarmState._fields, res_final, full_final):
        assert torch.equal(a, b), name
    assert ((tmp_path / "full" / "gso_20.out").read_text()
            == (tmp_path / "res" / "gso_20.out").read_text())
    with pytest.raises(FileNotFoundError):
        resumed.load_snapshot(tmp_path / "nowhere" / "gso_10.out")


def test_cuda_runner_raises_without_gpu(monkeypatch):
    """No silent fallback: asking for the GPU without one is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, pos = _toy(1, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        GsoTorchRunner(from_reference(params), pos, seed=1, use_anm=False, anm_rec=0,
                       anm_lig=0, device="cuda")


@pytest.mark.parametrize("worklist", [False, True])
def test_runner_matches_jax_runner_text_dfire_anm(tmp_path, monkeypatch, worklist):
    """f64 on CPU, DFIRE with two ANM modes on each side (K1 with a
    per-pose receptor, or the work-list K2, forced by lowering the rule's
    threshold): gso_1.out and gso_10.out text-identical to GsoJaxRunner on
    the XLA path."""
    if worklist:
        monkeypatch.setattr(energy_kernel, "WORKLIST_MIN_TILES", 1)
    params, pos = _toy(13, num_anm=2)
    ref = GsoJaxRunner(params, pos, seed=324324, use_anm=True, anm_rec=2,
                       anm_lig=2, output_directory=str(tmp_path / "jax"),
                       dtype=jnp.float64, energy_mode="xla")
    ref.run(10)
    port = GsoTorchRunner(from_reference(params), pos, seed=324324,
                          use_anm=True, anm_rec=2, anm_lig=2,
                          output_directory=str(tmp_path / "torch"),
                          dtype=torch.float64, device="cpu")
    assert port.energy_fn.kernel.__name__ == ("dfire_pairs_worklist" if worklist
                                              else "dfire_pairs")
    final, outs = port.run(10)
    assert not torch.equal(final.a_rec, torch.as_tensor(pos[:, 7:9]))  # modes moved
    for step in (1, 10):
        a = (tmp_path / "jax" / f"gso_{step}.out").read_text()
        b = (tmp_path / "torch" / f"gso_{step}.out").read_text()
        assert a == b, f"gso_{step}.out differs"


def test_runner_defaults_to_the_card(monkeypatch):
    """Without a device the runner runs on the card, and raises where torch
    sees none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, pos = _toy(2, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        GsoTorchRunner(from_reference(params), pos, seed=1, use_anm=False,
                       anm_rec=0, anm_lig=0)


@pytest.mark.parametrize("method,num_anm,seed", [("dfire", 0, 11), ("dna", 2, 15)])
def test_kernel_v1_runner_matches_jax_pallas_v1_text(tmp_path, method, num_anm, seed):
    """f64 on CPU, energy_mode='kernel_v1' (K4 or K5, plain versions)
    against GsoJaxRunner(energy_mode='pallas_v1') in interpret mode: DFIRE
    with the step tables, DNA with two ANM modes on each side; gso_1.out and
    gso_10.out text-identical."""
    params, pos = _toy(seed, method=method, num_anm=num_anm, dfire_mode="steps")
    kw = dict(seed=324324, use_anm=num_anm > 0, anm_rec=num_anm, anm_lig=num_anm)
    ref = GsoJaxRunner(params, pos, output_directory=str(tmp_path / "jax"),
                       dtype=jnp.float64, energy_mode="pallas_v1", **kw)
    ref.run(10)
    port = GsoTorchRunner(from_reference(params), pos,
                          output_directory=str(tmp_path / "torch"),
                          dtype=torch.float64, device="cpu",
                          energy_mode="kernel_v1", **kw)
    assert port.energy_fn.kernel.__name__ == ("dfire_pairs_v1" if method == "dfire"
                                              else "elec_vdw_pairs_v1")
    final, _ = port.run(10)
    assert not torch.equal(final.t, torch.as_tensor(pos[:, :3]))   # the swarm moved
    for step in (1, 10):
        a = (tmp_path / "jax" / f"gso_{step}.out").read_text()
        b = (tmp_path / "torch" / f"gso_{step}.out").read_text()
        assert a == b, f"gso_{step}.out differs"


@pytest.mark.parametrize("method,num_anm", [("dfire", 0), ("pydock", 2)])
def test_dense_runner_matches_jax_xla_text(tmp_path, method, num_anm):
    """f64 on CPU, energy_mode='dense' (the dense oracle, chunked) against
    GsoJaxRunner(energy_mode='xla'): gso_1.out and gso_10.out
    text-identical."""
    params, pos = _toy(16, method=method, num_anm=num_anm)
    kw = dict(seed=324324, use_anm=num_anm > 0, anm_rec=num_anm, anm_lig=num_anm,
              energy_chunk=7)
    ref = GsoJaxRunner(params, pos, output_directory=str(tmp_path / "jax"),
                       dtype=jnp.float64, energy_mode="xla", **kw)
    ref.run(10)
    port = GsoTorchRunner(from_reference(params), pos,
                          output_directory=str(tmp_path / "torch"),
                          dtype=torch.float64, device="cpu", energy_mode="dense", **kw)
    port.run(10)
    for step in (1, 10):
        a = (tmp_path / "jax" / f"gso_{step}.out").read_text()
        b = (tmp_path / "torch" / f"gso_{step}.out").read_text()
        assert a == b, f"gso_{step}.out differs"


def test_runner_energy_modes(tmp_path):
    """'auto' is 'dense' off the card (``pick_energy_mode``, as JAX's is
    'xla' off a TPU) while an explicit 'kernel' stays the v2 kernel; an
    unknown mode raises; the bf16 step tables reach K4 and stay close to
    the f32 run."""
    params, pos = _toy(17, dtype=np.float32, dfire_mode="steps")
    kw = dict(seed=5, use_anm=False, anm_rec=0, anm_lig=0, device="cpu")
    auto = GsoTorchRunner(from_reference(params), pos, energy_mode="auto", **kw)
    assert auto.energy_mode == "dense"
    assert getattr(auto.energy_fn, "kernel", None) is None
    kernel = GsoTorchRunner(from_reference(params), pos, energy_mode="kernel", **kw)
    assert kernel.energy_mode == "kernel"
    assert kernel.energy_fn.kernel.__name__ == "dfire_pairs"
    with pytest.raises(ValueError, match="energy_mode"):
        GsoTorchRunner(from_reference(params), pos, energy_mode="xla", **kw)
    f32 = GsoTorchRunner(from_reference(params), pos, energy_mode="kernel_v1", **kw)
    b16 = GsoTorchRunner(from_reference(params), pos, energy_mode="kernel_v1",
                         dq_bf16=True, **kw)
    assert b16.params.dfire_dq.dtype == torch.bfloat16
    a, b = f32.run(1)[1].scoring, b16.run(1)[1].scoring
    assert not torch.equal(a, b)
    assert float(((b - a) / a).abs().max()) < 0.05


def test_runner_cull_off_matches_cull_on_and_jax(tmp_path):
    """f64 on CPU, DFIRE through the kernel path: ``cull=False`` reaches the
    energy function (a pose 100 A out keeps every tile bit) and renders
    gso_1.out and gso_10.out text-identical to ``cull=True`` and to
    ``GsoJaxRunner(energy_mode='pallas', cull=False)`` in interpret mode."""
    params, pos = _toy(18)
    kw = dict(seed=324324, use_anm=False, anm_rec=0, anm_lig=0)
    ref = GsoJaxRunner(params, pos, output_directory=str(tmp_path / "jax"),
                       dtype=jnp.float64, energy_mode="pallas", cull=False,
                       interpret=True, **kw)
    ref.run(10)
    texts = {}
    for cull in (True, False):
        port = GsoTorchRunner(from_reference(params), pos,
                              output_directory=str(tmp_path / f"cull_{cull}"),
                              dtype=torch.float64, device="cpu", cull=cull, **kw)
        far = torch.tensor([[100.0, 0.0, 0.0]], dtype=torch.float64)
        q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
        none = torch.zeros((1, 0), dtype=torch.float64)
        args, _ = port.energy_fn.kernel_args(port.params, far, q, none, none)
        assert bool(args[3].all()) == (not cull)
        port.run(10)
        texts[cull] = {s: (tmp_path / f"cull_{cull}" / f"gso_{s}.out").read_text()
                       for s in (1, 10)}
    for step in (1, 10):
        jax_text = (tmp_path / "jax" / f"gso_{step}.out").read_text()
        assert texts[False][step] == texts[True][step], f"gso_{step}.out differs"
        assert texts[False][step] == jax_text, f"gso_{step}.out differs from JAX"
