"""The plain reference against the program's own plain paths on the CPU, at
float64 and a small size: the random stream, the DFIRE and DNA scores with
their bracket (DNA with ANM modes on both sides), and the GSO steps that
``reference.gso.follow`` vouches for, rigid and with ANM; and the rigid
DFIRE scores bit for bit as they were before the pose transform and the
bias were shared between the methods.

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
from reference import dfire as ref_dfire  # noqa: E402
from reference import gso as ref_gso  # noqa: E402
from reference.pose import rotation  # noqa: E402
from reference.rng import uniforms  # noqa: E402

EXAMPLE = HERE / "examples" / "1azp-dna-anm.glob32.json"


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
        sim = load_simulation(str(cx.setup), str(path), config["method"], anm_dir=str(cx.root))
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


def dna_config(**sizes):
    """The example 1azp DNA + 10 + 10 ANM configuration at ``sizes``."""
    config = json.loads(EXAMPLE.read_text())["files"]["configs/1azp-dna-anm.json"]
    return dict(config, **sizes)


def split(poses, anm_rec):
    """(t, q, a_rec, a_lig) tensors of positions rows."""
    x = torch.tensor(poses)
    return x[:, :3], x[:, 3:7], x[:, 7:7 + anm_rec], x[:, 7 + anm_rec:]


def test_dna_scores_match_the_program(tmp_path):
    """The reference's DNA score of each pose, with 10 + 10 ANM modes,
    equals the program's dense energy at float64, within its bracket."""
    from lightdock_tpu_torch.engine import energy_dense

    config = dna_config(receptor_atoms=400, ligand_atoms=90, glowworms=64)
    cx, sim, params = complex_and_program(tmp_path, config, 5)
    poses = cx.positions(0, 1)[0]
    assert poses.shape == (64, 27) and sim.use_anm and params.rec_nmodes.shape[0] == 10
    mid, lo, hi = check.make_scorer(cx, "cpu", torch.float64).score(
        poses[:, :3], poses[:, 3:7], poses[:, 7:])
    prog = energy_dense.batch_energy(params, *split(poses, 10)).numpy()
    assert np.allclose(prog, mid, rtol=1e-12, atol=1e-9)
    assert np.all(lo <= mid + 1e-12) and np.all(mid <= hi + 1e-12)
    assert np.ptp(mid) > 1.0
    # The modes move the score: the same poses rigid score otherwise.
    rigid = check.make_scorer(cx, "cpu", torch.float64).score(
        poses[:, :3], poses[:, 3:7], 0 * poses[:, 7:])[0]
    assert np.abs(rigid - mid).max() > 1e-3


def test_follow_with_anm_matches_the_program(tmp_path):
    """Ten steps of the program's GSO at float64 on the DNA + ANM complex:
    every glowworm the follow vouches for has the program's pose and
    receptor and ligand coefficients, luciferin, neighbours, vision and
    score."""
    from lightdock_tpu_torch.engine import energy_dense, gso

    config = dna_config(receptor_atoms=400, ligand_atoms=90, glowworms=60, swarm_radius=4.0)
    cx, sim, params = complex_and_program(tmp_path, config, 9)
    poses = cx.positions(0, 1)[0]
    steps = 10
    seed = json.loads(cx.setup.read_text())["seed"]
    draws = uniforms(seed, steps * 60).reshape(steps, 60)
    state = gso.init_state(poses, True, 10, 10, torch.float64, "cpu")
    for k in range(steps):
        state, _ = gso.gso_step(params, state, torch.tensor(draws[k]), energy_dense.batch_energy)
    scorer = check.make_scorer(cx, "cpu", torch.float64)
    out, ok, luc_band, _ = ref_gso.follow(ref_gso.initial(poses), draws, scorer.score,
                                          anm_rec=10)
    assert ok.mean() > 0.5
    assert int((state.num_neighbors.numpy() > 0).sum()) > 10
    got = torch.cat([state.t, state.q, state.a_rec, state.a_lig], dim=1).numpy()
    ref = np.concatenate([out.t, out.q, out.anm], axis=1)
    assert np.allclose(got[ok], ref[ok], atol=1e-9)
    # In one step each side's coefficients move 0.5 along their own
    # direction, not the 20 as one vector.
    before = ref_gso.follow(ref_gso.initial(poses), draws[:5], scorer.score, anm_rec=10)[0]
    one = ref_gso.follow(before, draws[5:6], scorer.score, anm_rec=10)[0]
    moved = np.abs(one.anm - before.anm).max(axis=1) > 0
    assert moved.sum() > 10
    for side in (slice(0, 10), slice(10, 20)):
        step = np.linalg.norm(one.anm[moved, side] - before.anm[moved, side], axis=1)
        assert np.allclose(step, 0.5, atol=1e-12)
    assert np.allclose(state.luciferin.numpy()[ok], out.luciferin[ok], atol=1e-9)
    assert np.array_equal(state.num_neighbors.numpy()[ok], out.neighbours[ok])
    assert np.allclose(state.vision.numpy()[ok], out.vision[ok], atol=1e-12)
    assert np.allclose(state.scoring.numpy()[ok], out.score[ok], atol=1e-9)
    lum = state.luciferin.numpy()[ok]
    assert np.all((luc_band[ok, 0] <= lum) & (lum <= luc_band[ok, 1]))


def rigid_dfire_before(scorer, t, q):
    """(score, low, high) of rigid poses as ``DfireScorer`` computed them
    before the pose transform and the bias were shared (a frozen copy of
    that arithmetic, on the scorer's own tables)."""
    dt, dev, e = scorer.dtype, scorer.device, scorer.eps
    rec, lig = scorer.poser.rec, scorer.poser.lig
    rec_r, lig_r, beads = (scorer.bias.rec_restraints, scorer.bias.lig_restraints,
                           scorer.bias.membrane)

    def share(residues, pick):
        if not residues:
            return torch.zeros((), dtype=torch.float64, device=dev)
        return torch.stack([pick(idx).flatten(1).any(dim=1) for idx in residues]).double().mean(dim=0)

    def membrane(near):
        if beads.numel() == 0:
            return torch.zeros((), dtype=torch.float64, device=dev)
        return near[:, beads, :].any(dim=2).double().mean(dim=1)

    t = torch.as_tensor(np.asarray(t, np.float64), device=dev).to(dt)
    q = torch.as_tensor(np.asarray(q, np.float64), device=dev).to(dt)
    lig = torch.einsum("pij,nj->pni", rotation(q), lig) + t[:, None, :]
    d2 = sum((lig[:, None, :, c] - rec[None, :, None, c]) ** 2 for c in range(3))
    d = torch.sqrt(d2)
    within = d2 <= ref_dfire.CUTOFF2
    u = 2.0 * d - 1.0
    slot = torch.clamp(torch.trunc(torch.nan_to_num(u, nan=ref_dfire.N_SLOTS)), 0,
                       ref_dfire.N_SLOTS - 1).to(torch.int64)
    value = scorer.table[scorer.row[None] + scorer.bin_of_slot[slot]]
    value = torch.where(within, value, torch.zeros((), dtype=dt, device=dev))
    raw = value.sum(dim=(1, 2), dtype=dt).double()
    near = d2 <= ref_dfire.CONTACT ** 2
    fr = share(rec_r, lambda idx: near[:, idx, :])
    fl = share(lig_r, lambda idx: near[:, :, idx])
    score = ((ref_dfire.OFFSET - ref_dfire.SCALE * raw) * (1.0 + fr + fl)
             - 999.0 * membrane(near))
    edge = torch.round(u)
    on_edge = (torch.abs(u - edge) < 2 * e) & (edge >= 1) & (edge <= ref_dfire.CUTOFF_SLOT)
    p, r, l = torch.nonzero(on_edge, as_tuple=True)
    m = edge[p, r, l].to(torch.int64)
    row = scorer.row[r, l]
    below = scorer.table[row + scorer.bin_of_slot[m - 1]]
    above = scorer.table[row + scorer.bin_of_slot[m]]
    above_or_out = torch.where(m == ref_dfire.CUTOFF_SLOT, torch.zeros_like(above), above)
    options = torch.stack([below, above, above_or_out])
    now = value[p, r, l]
    low = torch.zeros_like(raw).index_add_(0, p, (options.min(0).values - now).double())
    high = torch.zeros_like(raw).index_add_(0, p, (options.max(0).values - now).double())
    raw_lo, raw_hi = raw + low, raw + high
    shares = []
    for contact in (d < ref_dfire.CONTACT - e, d <= ref_dfire.CONTACT + e):
        shares.append((share(rec_r, lambda idx: contact[:, idx, :])
                       + share(lig_r, lambda idx: contact[:, :, idx]), membrane(contact)))
    (f_lo, m_lo), (f_hi, m_hi) = shares
    base = torch.stack([ref_dfire.OFFSET - ref_dfire.SCALE * raw_hi,
                        ref_dfire.OFFSET - ref_dfire.SCALE * raw_lo])
    factor = torch.stack([1.0 + f_lo + 0 * raw, 1.0 + f_hi + 0 * raw])
    corners = (base[:, None] * factor[None, :]).reshape(4, -1)
    lo = corners.min(0).values - 999.0 * (m_hi + 0 * raw)
    hi = corners.max(0).values - 999.0 * (m_lo + 0 * raw)
    return score.numpy(), lo.numpy(), hi.numpy()


@pytest.mark.parametrize("name", ["1ppe-dfire-rigid", "1k4c-dfire-membrane"])
def test_rigid_dfire_is_unchanged(tmp_path, name):
    """Rigid DFIRE, with no coefficients and with zero-width ones, gives the
    scores and brackets it gave before, bit for bit."""
    config = dict(manifest.load("configs", name), receptor_atoms=400, ligand_atoms=90,
                  glowworms=64)
    if config.get("membrane"):
        config["membrane"] = dict(config["membrane"], beads=60)
    cx = Complex(config, 2 ** 31 + 19, tmp_path / "cx")
    poses = cx.positions(3, 1)[0]
    scorer = check.make_scorer(cx, "cpu", torch.float64)
    before = rigid_dfire_before(scorer, poses[:, :3], poses[:, 3:7])
    for anm in (None, poses[:, 7:]):
        assert poses[:, 7:].shape == (64, 0)
        now = scorer.score(poses[:, :3], poses[:, 3:7], anm)
        for a, b in zip(now, before):
            assert np.array_equal(a, b)
    assert np.ptp(before[0]) > 1.0 and (before[2] > before[1]).any()
