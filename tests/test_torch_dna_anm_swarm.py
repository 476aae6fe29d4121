"""The 1azp DNA + ANM deployment run one swarm a job, on the CPU at a small
size: the ``anm_pose`` span (``utils.metrics``) that the kernel path's
``kernel_args`` and the dense path's ``batch_pose_coords`` open around the
mode sums, inside ``energy``, and only where a side has modes; the
energies it leaves as they were; ``auto``'s pick at 1azp's shapes; and the
command line on one positions file of a DNA + ANM complex, whose snapshots
the benchmark's plain reference (``benchmark/reference``: ``dna.py`` and
``gso.py``) scores and follows within the cell's limits."""

import contextlib
import io
import json
import os
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch import cli, standin  # noqa: E402
from lightdock_tpu_torch.engine import energy_dense, gso  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    frame_center, kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import torch_params  # noqa: E402
from lightdock_tpu_torch.engine.runner import pick_energy_mode  # noqa: E402
from lightdock_tpu_torch.ops import quaternion as qt  # noqa: E402
from lightdock_tpu_torch.utils import metrics  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
G = 24


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def system(path, num_anm, seed=3):
    """(energy_fn, tensor params, state, NumPy params) of a 60 x 30 atom
    DNA stand-in with ``num_anm`` modes a side and G glowworms, on the
    kernel path (its plain kernels on the CPU) or the dense path."""
    params, pos, _ = standin.toy_system(60, 30, G, num_anm=num_anm, seed=seed, method="dna")
    if path == "kernel":
        params = kernel_params(params)
        fn = make_kernel_energy_fn(params, "cpu", torch.float32)
    else:
        fn = energy_dense.batch_energy
    tp = torch_params(params, "cpu", torch.float32)
    state = gso.init_state(pos, num_anm > 0, num_anm, num_anm, torch.float32, "cpu")
    return fn, tp, state, params


def step_spans(path, num_anm):
    """The spans one GSO step records with a recorder active."""
    fn, tp, state, _ = system(path, num_anm)
    with metrics.record() as rec:
        gso.gso_step(tp, state, torch.rand(G, dtype=torch.float32), fn)
        spans, _ = rec.take()
    return spans


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_one_anm_pose_span_inside_energy(path):
    spans = step_spans(path, 3)
    anm = [s for s in spans if s[0] == "anm_pose"]
    energy = [s for s in spans if s[0] == "energy"]
    assert len(anm) == 1 and len(energy) == 1
    (_, a0, a1), (_, e0, e1) = anm[0], energy[0]
    assert e0 <= a0 <= a1 <= e1


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_rigid_call_records_no_anm_pose(path):
    spans = step_spans(path, 0)
    assert [s for s in spans if s[0] == "energy"]
    assert not [s for s in spans if s[0] == "anm_pose"]


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_energies_unchanged_by_the_span(path):
    """With no recorder, with one, and as the mode sums compute them with
    no span around them, the energies and the posed coordinates are equal
    bit for bit."""
    fn, tp, s, params = system(path, 3)
    args = (tp, s.t, s.q, s.a_rec, s.a_lig)
    plain = fn(*args)
    with metrics.record():
        recorded = fn(*args)
    assert torch.equal(plain, recorded) and torch.isfinite(plain).all()
    rot = qt.rotation_matrix(s.q)
    if path == "kernel":
        center = torch.as_tensor(frame_center(params), dtype=torch.float32)
        (rec, lig, *_), _ = fn.kernel_args(*args)
        want_lig = (energy_dense.rotate_translate(rot, tp.lig_coords, s.t - center[None, :])
                    + energy_dense.mode_sum(s.a_lig, tp.lig_nmodes).transpose(1, 2))
        want_rec = ((tp.rec_coords - center[None, :])[None]
                    + energy_dense.mode_sum(s.a_rec, tp.rec_nmodes))
    else:
        rec, lig = energy_dense.batch_pose_coords(*args)
        want_lig = (energy_dense.rotate_translate(rot, tp.lig_coords, s.t).transpose(1, 2)
                    + energy_dense.mode_sum(s.a_lig, tp.lig_nmodes))
        want_rec = tp.rec_coords[None] + energy_dense.mode_sum(s.a_rec, tp.rec_nmodes)
    assert torch.equal(rec, want_rec) and torch.equal(lig, want_lig)


def shapes(n_rec, n_lig, modes, method="dna"):
    return types.SimpleNamespace(
        rec_coords=np.zeros((n_rec, 3)), lig_coords=np.zeros((n_lig, 3)), use_anm=modes > 0,
        rec_nmodes=np.zeros((modes, n_rec, 3)), lig_nmodes=np.zeros((modes, n_lig, 3)),
        method=method)


def test_auto_picks_the_kernel_at_1azp():
    """1094 x 506 atoms, 10 + 10 modes: 200 poses a call op by op are
    110.7M pair-poses, over the 60M threshold of DNA; 100 poses (55.3M) are
    under it, but replayed steps take the kernel; off a CUDA device the
    pick is dense."""
    cuda = torch.device("cuda")
    assert pick_energy_mode(shapes(1094, 506, 10), cuda, 200) == "kernel"
    assert pick_energy_mode(shapes(1094, 506, 10), cuda, 100) == "dense"
    assert pick_energy_mode(shapes(1094, 506, 10), cuda, 100, replayed=True) == "kernel"
    assert pick_energy_mode(shapes(1094, 506, 10), torch.device("cpu"), 200) == "dense"


@pytest.fixture
def bench_path(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))


@pytest.mark.parametrize("modes", [3, 10])
def test_cli_one_swarm_matches_the_reference(tmp_path, bench_path, modes):
    """``cli.main`` on one positions file of a 200 x 60 atom DNA complex
    with ``modes`` + ``modes`` ANM modes, 30 glowworms, 10 steps: the
    snapshots hold 7 + 2 ``modes`` pose columns (27 with 1azp's ten), and
    the reference scores and follows them within the cell's limits."""
    from ldbench import check
    from ldbench.inputs import Complex
    from reference import gsofile

    config = json.loads((BENCH / "configs" / "1azp-dna-anm.json").read_text())
    config.update(receptor_atoms=200, ligand_atoms=60, anm_rec=modes, anm_lig=modes,
                  glowworms=30, steps=10, swarm_centres=3)
    limits = json.loads((BENCH / "workloads" / "1azp-dna-anm.swarm1.json").read_text())["limits"]
    seed = 2 ** 31 + 24
    cx = Complex(config, seed, tmp_path / "complex")
    job = tmp_path / "job"
    (positions,) = cx.write_job(0, 1, job)
    argv = [str(cx.setup), str(positions), "10", "dna", "--anm-dir", str(cx.root),
            "--platform", "cpu"]
    old = os.getcwd()
    os.chdir(job)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(argv) == 0
    finally:
        os.chdir(old)
    for k in (1, 10):
        poses = gsofile.read(job / "swarm_0" / f"gso_{k}.out")[0]
        assert poses.shape == (30, 7 + 2 * modes)
    checker = check.Checker(cx, "cpu", {"jobs": 1, "swarms": 1, "segments": 2,
                                        "score_snapshots": 2})
    correct, failed, found = check.verify(
        checker, [{"dir": job, "initial": cx.positions(0, 1), "ok": True, "job": 0}],
        seed, limits)
    assert correct and failed == 0, found
    assert checker.checked["glowworms_followed"] > 0 and checker.checked["segments"] == 2
