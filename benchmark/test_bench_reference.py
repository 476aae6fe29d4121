"""The plain reference against the program's own plain paths on the CPU, at
float64 and a small size: the random stream, the DFIRE scores with their
bracket, and the GSO steps that ``reference.gso.follow`` vouches for.

    python -m pytest benchmark/test_bench_reference.py -q
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from ldbench import check, manifest  # noqa: E402
from ldbench.inputs import Complex  # noqa: E402
from reference import gso as ref_gso  # noqa: E402
from reference.rng import uniforms  # noqa: E402

@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 324324, 2 ** 31 + 11])
def test_stream_matches_the_program(seed):
    from lightdock_tpu_torch.utils.rng import uniform_f64_stream

    assert np.array_equal(uniforms(seed, 1000), uniform_f64_stream(seed, 1000))


def complex_and_program(tmp_path, config, seed):
    from lightdock_tpu_torch.engine.params import torch_params
    from lightdock_tpu_torch.simulation import load_simulation

    cx = Complex(config, seed, tmp_path / "cx")
    path = cx.write_job(0, 1, tmp_path / "job")[0]
    import os

    old = os.environ.get("LIGHTDOCK_DATA")
    os.environ["LIGHTDOCK_DATA"] = str(cx.data)
    try:
        sim = load_simulation(str(cx.setup), str(path), "dfire")
        params = torch_params(sim.batch_params(), "cpu", torch.float64)
    finally:
        if old is None:
            del os.environ["LIGHTDOCK_DATA"]
        else:
            os.environ["LIGHTDOCK_DATA"] = old
    return cx, sim, params


@pytest.mark.parametrize("name", ["1ppe-dfire-rigid", "1k4c-dfire-membrane"])
def test_scores_match_the_program(tmp_path, name):
    """The reference's score of each pose equals the program's dense energy
    at float64, within its bracket, and the membrane and restraints
    count."""
    from lightdock_tpu_torch.engine import energy_dense

    config = dict(manifest.load("configs", name), receptor_atoms=400, ligand_atoms=90,
                  glowworms=64)
    if config.get("membrane"):
        config["membrane"] = dict(config["membrane"], beads=60)
    cx, sim, params = complex_and_program(tmp_path, config, 5)
    poses = cx.positions(0, 1)[0]
    mid, lo, hi = check.make_scorer(cx, "cpu", torch.float64).score(poses[:, :3],
                                                                            poses[:, 3:7])
    zero = torch.zeros((len(poses), 0), dtype=torch.float64)
    prog = energy_dense.batch_energy(params, torch.tensor(poses[:, :3]),
                                     torch.tensor(poses[:, 3:7]), zero, zero).numpy()
    assert np.allclose(prog, mid, rtol=1e-12, atol=1e-9)
    assert np.all(lo <= mid + 1e-12) and np.all(mid <= hi + 1e-12)
    assert np.ptp(mid) > 1.0
    if name.startswith("1k4c"):
        assert sim.receptor.membrane.size == cx.n_beads > 0


def test_follow_matches_the_program(tmp_path):
    """Ten steps of the program's GSO at float64 from a swarm's positions:
    every glowworm the follow vouches for has the program's pose,
    luciferin, neighbours, vision and score."""
    from lightdock_tpu_torch.engine import energy_dense, gso

    config = dict(manifest.load("configs", "1ppe-dfire-rigid"), receptor_atoms=400,
                  ligand_atoms=90, glowworms=60, swarm_radius=4.0)
    cx, sim, params = complex_and_program(tmp_path, config, 9)
    poses = cx.positions(0, 1)[0]
    steps = 10
    seed = json.loads(cx.setup.read_text())["seed"]
    draws = uniforms(seed, steps * 60).reshape(steps, 60)
    state = gso.init_state(poses, False, 0, 0, torch.float64, "cpu")
    for k in range(steps):
        state, _ = gso.gso_step(params, state, torch.tensor(draws[k]), energy_dense.batch_energy)
    scorer = check.make_scorer(cx, "cpu", torch.float64)
    out, ok, luc_band, score_band = ref_gso.follow(ref_gso.initial(poses), draws,
                                                   lambda t, q, a: scorer.score(t, q))
    assert ok.mean() > 0.5
    assert int((state.num_neighbors.numpy() > 0).sum()) > 10
    got = np.concatenate([state.t.numpy(), state.q.numpy()], axis=1)[ok]
    assert np.allclose(got, np.concatenate([out.t, out.q], axis=1)[ok], atol=1e-9)
    assert np.allclose(state.luciferin.numpy()[ok], out.luciferin[ok], atol=1e-9)
    assert np.array_equal(state.num_neighbors.numpy()[ok], out.neighbours[ok])
    assert np.allclose(state.vision.numpy()[ok], out.vision[ok], atol=1e-12)
    assert np.allclose(state.scoring.numpy()[ok], out.score[ok], atol=1e-9)
    lum = state.luciferin.numpy()[ok]
    assert np.all((luc_band[ok, 0] <= lum) & (lum <= luc_band[ok, 1]))
