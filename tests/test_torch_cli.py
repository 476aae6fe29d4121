"""The port's command line (``lightdock_tpu_torch.cli``) against the JAX
package's (``lightdock_tpu.cli``) on the same files, on the CPU: complexes
of 60 x 30 atoms written by ``standin.write_complex``, 10 glowworms, 10
steps, float64.  Both command lines run in-process, in a working directory
of their own that holds the ANM files."""

import contextlib
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from lightdock_tpu.cli import main as jax_main  # noqa: E402
from lightdock_tpu.cli import pick_energy_chunk as jax_pick_energy_chunk  # noqa: E402
from lightdock_tpu.simulation import load_simulation as jax_load_simulation  # noqa: E402
from lightdock_tpu_torch import cli, standin  # noqa: E402
from lightdock_tpu_torch.engine import runner as runner_module  # noqa: E402
from lightdock_tpu_torch.engine.runner import GsoTorchRunner, native_stream  # noqa: E402
from lightdock_tpu_torch.simulation import load_simulation  # noqa: E402

N_REC, N_LIG, G, STEPS, NUM_ANM = 60, 30, 10, "10", 2
METHODS = {"dfire": 0, "dna": NUM_ANM, "pydock": 0}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run(fn, inputs, name, argv):
    """``fn(argv)`` in ``inputs / name``, a working directory holding the
    complex's ANM files; returns that directory."""
    work = inputs / name
    work.mkdir()
    for f in inputs.glob("*.npy"):
        shutil.copy(f, work / f.name)
    with _cwd(work):
        assert fn([str(a) for a in argv]) == 0
    return work


def _text(work, step, swarm=0):
    return (work / f"swarm_{swarm}" / f"gso_{step}.out").read_text()


@pytest.fixture(scope="module")
def complexes(tmp_path_factory):
    """Per method: (input directory, setup.json, positions files, the JAX
    command line's working directory after its 10-step run of swarm 0)."""
    out = {}
    for method, num_anm in METHODS.items():
        root = tmp_path_factory.mktemp(method)
        setup, positions = standin.write_complex(root, method, N_REC, N_LIG, G,
                                                 num_anm=num_anm, n_swarms=3, seed=5)
        jax_work = _run(jax_main, root, "jax", [setup, positions[0], STEPS, method,
                                                "--platform", "cpu", "--metrics",
                                                root / "jax.jsonl"])
        out[method] = (root, setup, positions, jax_work)
    return out


@pytest.mark.parametrize("method", list(METHODS))
def test_cli_matches_jax_cli_text(complexes, method):
    """gso_1.out and gso_10.out text-identical to the JAX command line's at
    float64: DFIRE, DNA with 2 + 2 ANM modes (their columns written),
    PYDOCK."""
    root, setup, positions, jax_work = complexes[method]
    work = _run(cli.main, root, "torch", [setup, positions[0], STEPS, method,
                                          "--platform", "cpu"])
    for step in (1, 10):
        assert _text(work, step) == _text(jax_work, step), f"gso_{step}.out differs"
    row = _text(work, 10).splitlines()[1]
    assert len(row[row.index("(") + 1:row.index(")")].split(",")) == 7 + 2 * METHODS[method]


def test_cli_energy_modes_agree(complexes):
    """At float64 the kernel modes (the v2 kernels' and the v1 step
    tables' plain versions) render the text of the default mode ('auto',
    the dense mode on the CPU), which is JAX's."""
    root, setup, positions, jax_work = complexes["dfire"]
    for mode in ("kernel", "kernel_v1"):
        work = _run(cli.main, root, f"torch_{mode}", [
            setup, positions[0], STEPS, "dfire", "--platform", "cpu",
            "--energy-mode", mode])
        for step in (1, 10):
            assert _text(work, step) == _text(jax_work, step), (mode, step)


@pytest.mark.parametrize("method", ["dna", "pydock"])
def test_cli_kernel_mode_matches_jax_cli_text(complexes, method):
    """At float64 the v2 kernel mode (K3's plain version) renders the JAX
    command line's text for DNA with 2 + 2 ANM modes and for PYDOCK, as
    the default mode does (``test_cli_matches_jax_cli_text``)."""
    root, setup, positions, jax_work = complexes[method]
    work = _run(cli.main, root, "torch_kernel", [setup, positions[0], STEPS, method,
                                                 "--platform", "cpu", "--energy-mode",
                                                 "kernel"])
    for step in (1, 10):
        assert _text(work, step) == _text(jax_work, step), f"gso_{step}.out differs"


def test_cli_metrics_match_jax_keys(complexes):
    """--metrics writes the JAX command line's events with its keys
    (``backend`` 'cpu' in both), one segment a save and a summary, besides
    the port's own ``trace`` events (``tests/test_torch_trace.py``)."""
    root, setup, positions, _ = complexes["dfire"]
    _run(cli.main, root, "torch_metrics", [setup, positions[0], STEPS, "dfire",
                                           "--platform", "cpu", "--steps-per-save", "5",
                                           "--metrics", root / "torch.jsonl"])
    ours = [json.loads(ln) for ln in (root / "torch.jsonl").read_text().splitlines()]
    ours = [e for e in ours if e["event"] != "trace"]
    ref = [json.loads(ln) for ln in (root / "jax.jsonl").read_text().splitlines()]
    assert [e["event"] for e in ours] == ["segment", "segment", "summary"]
    assert [e["event"] for e in ref] == ["segment", "summary"]
    for event in ("segment", "summary"):
        a = next(e for e in ours if e["event"] == event)
        b = next(e for e in ref if e["event"] == event)
        assert a.keys() == b.keys(), event
    assert ours[-1]["total_poses_scored"] == G * int(STEPS)
    assert ours[0]["backend"] == ref[0]["backend"] == "cpu"
    assert ours[0]["poses"] == 5 * G and ours[0]["end_step"] == 5


def test_cli_multi_swarm_matches_jax(complexes):
    """A glob of 3 positions files runs the farm: every swarm's gso_1.out
    and gso_10.out text-identical to the JAX command line's multi mode."""
    root, setup, _, _ = complexes["dna"]
    glob = str(root / "initial_positions_*.dat")
    argv = [setup, glob, STEPS, "dna", "--platform", "cpu"]
    jax_work = _run(jax_main, root, "jax_multi", argv)
    work = _run(cli.main, root, "torch_multi", argv)
    assert sorted(p.name for p in work.glob("swarm_*")) == ["swarm_0", "swarm_1", "swarm_2"]
    for swarm in range(3):
        for step in (1, 10):
            assert _text(work, step, swarm) == _text(jax_work, step, swarm), (swarm, step)


def test_cli_text_resume_matches_jax(complexes):
    """--resume from a gso_10.out whose sidecar is deleted (the text path)
    renders the JAX command line's text resume: gso_20.out identical.
    Both take JAX's 'xla' mode (the port's dense mode): the text holds
    scores to 8 decimals, and the kernel modes keep an unmoved pose's
    stored score where the dense mode rescores it, so after a text resume
    the two modes part, in both packages alike (the port's kernel mode
    renders JAX's 'pallas' text)."""
    root, setup, positions, _ = complexes["pydock"]
    texts = []
    for name, fn in (("jax_resume", jax_main), ("torch_resume", cli.main)):
        flags = ["--platform", "cpu", "--energy-mode", "xla"]
        argv = [setup, positions[1], STEPS, "pydock", *flags]
        work = _run(fn, root, name, argv)
        (work / "swarm_1" / "gso_10.out.npz").unlink()
        with _cwd(work):
            assert fn([str(a) for a in argv[:2]] + ["20", "pydock", *flags,
                                                    "--resume", "swarm_1/gso_10.out",
                                                    "--resume-step", "10"]) == 0
        texts.append(_text(work, 20, swarm=1))
    assert texts[0] == texts[1]


def test_cli_resume_auto_after_interrupted_multi(complexes):
    """An interrupted multi-swarm run (10 steps) continued to 20 with
    --resume auto writes every swarm's gso_20.out byte-identical to an
    uninterrupted 20-step run (the sidecars carry the state's bits)."""
    root, setup, _, _ = complexes["dfire"]
    argv = [setup, f"{root / 'initial_positions_0.dat'},{root / 'initial_positions_2.dat'}",
            "20", "dfire", "--platform", "cpu"]
    full = _run(cli.main, root, "multi_full", argv)
    part = _run(cli.main, root, "multi_part", argv[:2] + [STEPS] + argv[3:])
    assert not (part / "swarm_2" / "gso_20.out").exists()
    with _cwd(part):
        assert cli.main([str(a) for a in argv] + ["--resume", "auto"]) == 0
    for swarm in (0, 2):
        assert _text(part, 20, swarm) == _text(full, 20, swarm), swarm


def test_cli_native_rng(complexes, monkeypatch):
    """--jax-rng takes the native stream: the runner draws steps x G from
    it, and two runs equal each other.  The stream is float32 in [0, 1), a
    longer stream begins with a shorter one, and a runner resumed at step
    10 takes the draws of steps 11-20 of the uninterrupted run."""
    root, setup, positions, _ = complexes["dfire"]
    calls = []

    def recorded(seed, device, n):
        calls.append((seed, str(device), n))
        return native_stream(seed, device, n)

    monkeypatch.setattr(runner_module, "native_stream", recorded)
    argv = [setup, positions[0], STEPS, "dfire", "--platform", "cpu", "--jax-rng"]
    a, b = (_run(cli.main, root, f"native_{i}", argv) for i in range(2))
    assert calls == [(324324, "cpu", int(STEPS) * G)] * 2
    assert _text(a, 10) == _text(b, 10)
    draws = native_stream(7, "cpu", 20000)
    assert draws.dtype == torch.float32
    assert float(draws.min()) >= 0.0 and float(draws.max()) < 1.0
    assert torch.equal(native_stream(7, "cpu", 300), draws[:300])
    with _cwd(root):
        sim = load_simulation(setup, positions[0], "dfire")
    runner = GsoTorchRunner(sim.batch_params(), sim.positions, sim.seed, False, 0, 0,
                            dtype=torch.float64, device="cpu", rng_mode="native")
    full = runner._randoms(20)
    runner._start_step = 10
    assert torch.equal(runner._randoms(20), full[10:])
    with pytest.raises(ValueError, match="rng_mode"):
        GsoTorchRunner(sim.batch_params(), sim.positions, sim.seed, False, 0, 0,
                       device="cpu", rng_mode="threefry")


def test_runner_modes_take_their_tables_from_batch_params(complexes):
    """``Simulation.batch_params()`` serves every energy mode of the
    runner: kernel_v1 builds the DFIRE step tables it reads, the dense mode
    reads them at float32 (as JAX's 'xla' mode does) and the gather at
    float64; the float32 step-1 scores of the three modes agree to 1e-4."""
    root, setup, positions, _ = complexes["dfire"]
    with _cwd(root):
        sim = load_simulation(setup, positions[0], "dfire")
    kw = dict(seed=sim.seed, use_anm=False, anm_rec=0, anm_lig=0, device="cpu")
    f64 = GsoTorchRunner(sim.batch_params(), sim.positions, dtype=torch.float64,
                         energy_mode="dense", **kw)
    assert f64.params.dfire_dq is None
    scores = {}
    for mode in ("kernel", "kernel_v1", "dense"):
        runner = GsoTorchRunner(sim.batch_params(np.float32), sim.positions,
                                dtype=torch.float32, energy_mode=mode, **kw)
        assert (runner.params.dfire_dq is None) == (mode == "kernel")
        scores[mode] = runner.run(1)[1].scoring[0].numpy()
    for mode in ("kernel_v1", "dense"):
        np.testing.assert_allclose(scores[mode], scores["kernel"], rtol=1e-4, atol=1e-4)


def test_cli_profile_writes_trace(complexes):
    root, setup, positions, _ = complexes["dfire"]
    work = _run(cli.main, root, "profiled", [setup, positions[0], "2", "dfire",
                                             "--platform", "cpu", "--profile"])
    trace = work / "swarm_0" / "torch_trace.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]


@pytest.mark.parametrize("argv,message", [
    (["--r-tile", "32"], "--r-tile"),
    (["--l-tile", "128"], "--l-tile"),
    (["--dtype", "float64"], "--energy-mode dense"),
    (["--dtype", "float64", "--energy-mode", "kernel_v1"], "--energy-mode dense"),
])
def test_cli_refuses_flags(complexes, capsys, argv, message):
    """The fixed tiles, and float64 on the card with a kernel mode, are
    refused by the parser before anything is read (no mode is switched)."""
    _, setup, positions, _ = complexes["dfire"]
    with pytest.raises(SystemExit) as exc:
        cli.main([str(setup), str(positions[0]), "1", "dfire", *argv])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_bad_method(complexes):
    _, setup, positions, _ = complexes["dfire"]
    with pytest.raises(SystemExit):
        cli.main([str(setup), str(positions[0]), "3", "nonsense", "--platform", "cpu"])


@pytest.mark.parametrize("platform", [[], ["--platform", "cuda"]])
def test_cli_runs_on_the_card_or_raises(complexes, monkeypatch, platform):
    """Without --platform cpu the run is on the card: where torch sees none
    it raises, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, setup, positions, _ = complexes["dfire"]
    with _cwd(root), pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(setup), str(positions[0]), "1", "dfire", *platform])
    assert not (root / "swarm_0").exists()


def test_energy_mode_aliases_and_chunk_rule(complexes, monkeypatch):
    """JAX's mode names map to the port's and its chunk rule is JAX's; the
    dense mode reads the chunk, the kernel modes score every pose in one
    call whatever chunk they are given, as JAX's Pallas paths do."""
    parser = cli.build_arg_parser()
    base = ["setup.json", "initial_positions_0.dat", "10", "DFIRE"]
    modes = {m: parser.parse_args(base + ["--energy-mode", m]).energy_mode
             for m in ("pallas", "xla", "auto", "kernel", "kernel_v1", "dense")}
    assert modes == {"pallas": "kernel", "xla": "dense", "auto": "auto", "kernel": "kernel",
                     "kernel_v1": "kernel_v1", "dense": "dense"}
    assert parser.parse_args(base).method == "dfire"
    for args in [(356_915, 200, 4), (356_915, 6400, 4), (553_564, 200, 8), (10, 10, 8)]:
        assert cli.pick_energy_chunk(*args) == jax_pick_energy_chunk(*args)
    assert cli.pick_energy_chunk(356_915, 200, 4) == 100

    calls = []
    built = runner_module.make_kernel_energy_fn

    def counted(*args, **kwargs):
        fn = built(*args, **kwargs)

        def call(p, t, *rest, **kw):
            calls.append(t.shape[0])
            return fn(p, t, *rest, **kw)
        return call

    monkeypatch.setattr(runner_module, "make_kernel_energy_fn", counted)
    root, setup, positions, _ = complexes["dfire"]
    with _cwd(root):
        sim = load_simulation(setup, positions[0], "dfire")
    for mode in ("kernel", "kernel_v1"):
        calls.clear()
        runner = GsoTorchRunner(sim.batch_params(), sim.positions, sim.seed, False, 0, 0,
                                dtype=torch.float64, device="cpu", energy_mode=mode,
                                energy_chunk=3)
        runner.run(1)
        assert calls == [G], mode
