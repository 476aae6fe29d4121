"""The hand-written CUDA kernels (DFIRE K1, K2 and K4, elec/vdw K3 and K5,
and the three probe templates of P1-P6) against their plain versions, the
energy path and the float64 host engine on the card against the CPU, and
the runner's steps replayed from CUDA graphs against the same steps op by
op.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports neither JAX nor
the JAX package (the systems come from ``lightdock_tpu_torch.standin``),
so it runs where they are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch.engine import energy_kernel  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch import probes  # noqa: E402
from lightdock_tpu_torch.engine.gso import SwarmState, run_swarm  # noqa: E402
from lightdock_tpu_torch.engine.gso_host import GsoHostEngine  # noqa: E402
from lightdock_tpu_torch.engine.runner import GsoTorchRunner  # noqa: E402
from lightdock_tpu_torch.engine.params import torch_params  # noqa: E402
from lightdock_tpu_torch.ops import cull  # noqa: E402
from lightdock_tpu_torch.ops import dfire_pairs as dp  # noqa: E402
from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4  # noqa: E402
from lightdock_tpu_torch.ops import elec_vdw_pairs as ev  # noqa: E402
from lightdock_tpu_torch.ops import elec_vdw_pairs_v1 as k5  # noqa: E402
from lightdock_tpu_torch.ops import probes as ops_probes  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.simulation import load_simulation  # noqa: E402
from lightdock_tpu_torch.standin import toy_system  # noqa: E402
from lightdock_tpu_torch.utils import metrics  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _clustered_kernel_args(dev, g, seed=2, method="dfire", num_anm=0):
    """The kernel's inputs for ``g`` poses clustered by chunk, so that some
    chunk-tiles are far: near bits come from the energy path's own box
    cull (truthful), cull and interface bits are seeded at random.  With
    ``num_anm`` > 0 the receptor is per pose (receptor ANM)."""
    params, pos, _ = toy_system(300, 170, g, num_anm=num_anm, seed=seed,
                                 method=method)
    params = kernel_params(params)
    fn = make_kernel_energy_fn(params, dev, torch.float32)
    tp = torch_params(params, dev, torch.float32)
    rng = np.random.RandomState(seed)
    n_c = -(-g // dp.POSE_BLOCK)
    t = (np.repeat(rng.uniform(-45, 45, (n_c, 3)), dp.POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3)))

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    args, kwargs = fn.kernel_args(
        tp, tensor(t), tensor(pos[:, 3:7]), tensor(pos[:, 7:7 + num_anm]),
        tensor(pos[:, 7 + num_anm:]))
    act = torch.as_tensor((rng.rand(*args[-2].shape) < 0.8).astype(np.int32), device=dev)
    iface = torch.as_tensor((rng.rand(*args[-1].shape) < 0.5).astype(np.int32), device=dev)
    return args[:-2] + (act, iface), kwargs


def _check_dfire_kernel(cuda, kernel, plain, g, with_near, need_iface, num_anm=0):
    """A DFIRE kernel against its plain version on clustered poses; two
    launches bit-equal."""
    args, kwargs = _clustered_kernel_args(cuda, g, num_anm=num_anm)
    assert args[0].shape[0] == (g if num_anm else 1)
    near = kwargs["near_chunks"]
    assert 0 < int(near.sum()) < near.numel()      # some chunk-tiles are far
    kw = dict(r_tile=kwargs["r_tile"], l_tile=kwargs["l_tile"],
              need_iface=need_iface, near_chunks=near if with_near else None)
    before = kernel.launches
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(*args, **kw)
    torch.testing.assert_close(out[0], ref[0], rtol=5e-5, atol=5e-5)
    if need_iface:
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        assert out[1].sum() > 0 and out[2].sum() > 0
    else:
        assert out[1] is None and out[2] is None
    again = kernel(*args, **kw)
    assert torch.equal(again[0], out[0])          # deterministic sums


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("with_near", [False, True])
@pytest.mark.parametrize("need_iface", [True, False])
def test_kernel_matches_plain(cuda, g, with_near, need_iface):
    _check_dfire_kernel(cuda, dp.dfire_pairs, dp.dfire_pairs_plain, g,
                        with_near, need_iface)


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("with_near", [False, True])
@pytest.mark.parametrize("need_iface", [True, False])
def test_worklist_kernel_matches_plain(cuda, g, num_anm, with_near, need_iface):
    """K2 against its plain version, rigid and per-pose receptor."""
    _check_dfire_kernel(cuda, dp.dfire_pairs_worklist,
                        dp.dfire_pairs_worklist_plain, g, with_near,
                        need_iface, num_anm)


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("need_iface", [True, False])
def test_per_pose_receptor_kernel_matches_plain(cuda, g, need_iface):
    """K1 with a (G, Nr, 3) receptor (receptor ANM) against plain."""
    _check_dfire_kernel(cuda, dp.dfire_pairs, dp.dfire_pairs_plain, g, True,
                        need_iface, num_anm=2)


@pytest.mark.parametrize("kernel", ["dfire_pairs", "dfire_pairs_worklist"])
def test_dfire_kernels_no_active_chunk(cuda, kernel):
    """No active chunk (every pose unmoved): K2's list is empty; both
    kernels give zero sums and no flags."""
    args, kwargs = _clustered_kernel_args(cuda, 37, num_anm=2)
    args = args[:3] + (torch.zeros_like(args[3]), torch.zeros_like(args[4]))
    out = getattr(dp, kernel)(*args, **kwargs)
    torch.cuda.synchronize()
    assert not out[0].any() and not out[1].any() and not out[2].any()


def _cull_inputs(dev, system, gated, monkeypatch):
    """The arguments the energy path hands ``cull_tile_bits`` at a cell's
    size, in its pose order: the 1k4c stand-in (membrane, three cutoffs,
    K2) at 6,400 poses, or the 1ppe stand-in at 200 poses, as one swarm
    45 A from the receptor's centre so that part of the grid is culled;
    with or without a moved gate."""
    if system == "1k4c":
        params, pos = standin.membrane_system(6400)
    else:
        params, pos, _ = toy_system(1615, 221, 200, seed=5)
        pos[:, :3] = pos[:, :3] * 0.5 + [45.0, 0.0, 0.0]
    params = kernel_params(params)
    fn = make_kernel_energy_fn(params, dev, torch.float32)
    g = pos.shape[0]
    x = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    none = torch.zeros((g, 0), device=dev)
    moved = (torch.as_tensor(np.random.RandomState(7).rand(g) < 0.6, device=dev)
             if gated else None)
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return cull.cull_tile_bits(*args, **kwargs)

    monkeypatch.setattr(energy_kernel, "cull_tile_bits", spy)
    fn(torch_params(params, dev, torch.float32), x[:, :3], x[:, 3:7], none, none,
       moved=moved, prev_scoring=torch.zeros(g, device=dev))
    (args, kwargs), = seen
    return args, kwargs


def _min_d2_f64(args, chunked):
    """Per cutoff: the float64 lower bound of each output entry, the least
    over its sub-box pairs (and its chunk's poses where chunked); inf for
    a pose the gate leaves out."""
    rc, rh, lc, lh, t, rot, slack, cuts, (rg, lg), _, moved = args
    g = t.shape[0]
    n_r, n_l = rc.shape[0] // rg, lc.shape[0] // lg
    f64 = [None if x is None else x.double() for x in (rc, rh, lc, lh, t, rot, slack)]
    s = f64[6] if f64[6] is not None else torch.zeros(g, dtype=torch.float64, device=t.device)
    per_pose = torch.empty((g, n_r, n_l), dtype=torch.float64, device=t.device)
    for a in range(0, g, 400):
        b = min(g, a + 400)
        d2 = cull.box_d2_lower_bound(*f64[:4], f64[4][a:b], f64[5][a:b], s[a:b],
                                     torch.zeros_like(s[a:b]))
        per_pose[a:b] = d2.reshape(b - a, n_r, rg, n_l, lg).amin(dim=(2, 4))
    if moved is not None:
        per_pose[~moved] = float("inf")
    per_pose = per_pose.permute(1, 2, 0)
    gp = -(-g // dp.POSE_BLOCK) * dp.POSE_BLOCK
    chunks = torch.nn.functional.pad(per_pose, (0, gp - g), value=float("inf")).reshape(
        n_r, n_l, gp // dp.POSE_BLOCK, dp.POSE_BLOCK).amin(dim=-1)
    return [chunks if c else per_pose for c in chunked]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("system", ["1k4c", "1ppe"])
def test_cull_kernel_matches_plain(cuda, system, gated, monkeypatch):
    """The cull kernel against the plain version on the card at the cells'
    sizes: every bit equal but where the entry's float64 lower bound lies
    within 1e-5 relative of the cutoff^2; no entry the float64 bound keeps
    dropped; the counters equal to the bits' sums; two launches equal."""
    args, kwargs = _cull_inputs(cuda, system, gated, monkeypatch)
    rc, rh, lc, lh, t, rot, slack, cuts, groups, chunked, moved = args
    assert kwargs == {"count": False} and len(cuts) == 3
    before = cull.cull_tile_bits.launches
    bits, counts = cull.cull_tile_bits(*args, count=True)
    again, _ = cull.cull_tile_bits(*args)
    torch.cuda.synchronize()
    assert cull.cull_tile_bits.launches == before + 2
    plain = cull.cull_tile_bits_plain(*args)
    bound = _min_d2_f64(args, chunked)
    report = []
    for k, c in enumerate(cuts):
        c2 = float(c) ** 2
        keep = bound[k] <= c2
        near = (bound[k] - c2).abs() <= 1e-5 * c2
        kern, ref = bits[k] != 0, plain[k] != 0
        assert torch.equal(bits[k], again[k])
        assert not bool((keep & ~kern).any()), f"cutoff {c}: an entry the bound keeps dropped"
        assert not bool(((kern != ref) & ~near).any()), f"cutoff {c}: bits differ off the edge"
        assert 0 < int(kern.sum()) < kern.numel()
        report.append(f"cutoff {c}: {int((kern != ref).sum())} of {kern.numel()} differ, "
                      f"{int(near.sum())} near")
    g = t.shape[0]
    n_r, n_l = rc.shape[0] // groups[0], lc.shape[0] // groups[1]
    live = g if moved is None else int(moved.sum())
    checked, kept = (int(x) for x in counts.to(torch.int64).sum(dim=0))
    per_pose, _ = cull.cull_tile_bits(*args[:9], (False,) * len(cuts), moved, count=False)
    assert checked == live * n_r * n_l and kept == int(per_pose[0].sum())
    print(f"{system} G={g} gated={gated}: " + "; ".join(report)
          + f"; checked {checked}, kept {kept}")


def test_cull_kernel_refuses_float64_on_card(cuda, monkeypatch):
    """On the card the cull takes the kernel whatever the dtype: float64
    inputs raise, and the plain chain never runs there."""
    args, _ = _cull_inputs(cuda, "1ppe", False, monkeypatch)
    f64 = [x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
           for x in args]
    monkeypatch.setattr(cull, "cull_tile_bits_plain", None)
    before = cull.cull_tile_bits.launches
    with pytest.raises(TypeError, match="float32"):
        cull.cull_tile_bits(*f64)
    assert cull.cull_tile_bits.launches == before


def test_energy_fn_on_card_matches_cpu(cuda):
    params, pos, _ = toy_system(300, 170, 37, seed=4)
    params = kernel_params(params)
    pose = [pos[:, :3], pos[:, 3:], np.zeros((37, 0)), np.zeros((37, 0))]
    out = {}
    for dev in ("cpu", cuda):
        fn = make_kernel_energy_fn(params, dev, torch.float32)
        tp = torch_params(params, dev, torch.float32)
        out[str(dev)] = fn(tp, *(torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev) for x in pose))
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-5, atol=5e-5)


# Stand-ins at the one-swarm cells' sizes: 1ppe DFIRE rigid, 1azp DNA with
# 10 + 10 ANM modes.
GRAPHED = {"1ppe": dict(n_rec=1615, n_lig=221, g=200),
           "1azp": dict(n_rec=1094, n_lig=506, g=200, num_anm=10, method="dna")}


def _graphed_runner(dev, system, out_dir=None):
    params, pos, num_anm = toy_system(**GRAPHED[system], seed=6)
    return GsoTorchRunner(params, pos, seed=17, use_anm=num_anm > 0, anm_rec=num_anm,
                          anm_lig=num_anm, output_directory=out_dir, device=dev)


@pytest.mark.parametrize("system", sorted(GRAPHED))
def test_graphed_runner_matches_eager(cuda, system, tmp_path):
    """30 steps of ``GsoTorchRunner`` (one op by op, 29 replayed) against
    the module-level ``run_swarm`` op by op from the same state and draws,
    the final state and the last segment's outputs: 1ppe bit-equal, 1azp
    within the kernels' 5e-5 and its neighbour counts equal.  Under a
    recorder the counters add up to the eager run's, with 29
    ``graph_steps``; each step launches the pair kernel and the cull."""
    runner = _graphed_runner(cuda, system, str(tmp_path))
    with metrics.record() as rec:
        ref_state, ref_outs = run_swarm(runner.params, runner.state, runner._randoms(30),
                                        runner.energy_fn)
        torch.cuda.synchronize()
        eager = rec.take()[1]
        kernel, culls = runner.energy_fn.kernel, cull.cull_tile_bits
        before = (kernel.launches, culls.launches)
        state, outs = runner.run_segmented(30, 10)
        torch.cuda.synchronize()
        graphed = rec.take()[1]
    assert (kernel.launches - before[0], culls.launches - before[1]) == (30, 30)
    for name in ("poses_scored", "cull_checked", "cull_kept"):
        assert graphed[name] == eager[name], name
    assert graphed["graph_steps"] == 29
    runner.release()
    assert outs.t.shape == ref_outs.t[20:].shape
    for name in SwarmState._fields:
        for got, want in ((getattr(state, name), getattr(ref_state, name)),
                          (getattr(outs, name), getattr(ref_outs, name)[20:])):
            if system == "1ppe" or name == "num_neighbors":
                assert torch.equal(got, want), name
            else:
                torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)


def test_graphed_resume_is_bit_exact(cuda, tmp_path):
    """A graphed run resumed from the step-20 sidecar ends on the bits of the
    uninterrupted graphed run."""
    full = _graphed_runner(cuda, "1ppe", str(tmp_path / "full"))
    want, _ = full.run_segmented(30, 10)
    resumed = _graphed_runner(cuda, "1ppe", str(tmp_path / "resumed"))
    resumed.load_snapshot(tmp_path / "full" / "gso_20.out")
    got, _ = resumed.run_segmented(30, 10)
    full.release()
    resumed.release()
    for name in SwarmState._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert ((tmp_path / "full" / "gso_30.out").read_bytes()
            == (tmp_path / "resumed" / "gso_30.out").read_bytes())


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("with_near", [False, True])
@pytest.mark.parametrize("need_iface", [True, False])
def test_elec_vdw_kernel_matches_plain(cuda, g, num_anm, with_near, need_iface):
    args, kwargs = _clustered_kernel_args(cuda, g, method="dna", num_anm=num_anm)
    assert args[0].shape[0] == (g if num_anm else 1)   # per-pose receptor with ANM
    near = kwargs["near_chunks"]
    assert 0 < int(near.sum()) < near.numel()      # some chunk-tiles are far
    kw = dict(r_tile=kwargs["r_tile"], l_tile=kwargs["l_tile"],
              need_iface=need_iface, near_chunks=near if with_near else None)
    before = ev.elec_vdw_pairs.launches
    out = ev.elec_vdw_pairs(*args, **kw)
    torch.cuda.synchronize()
    assert ev.elec_vdw_pairs.launches == before + 1
    ref = ev.elec_vdw_pairs_plain(*args, **kw)
    assert bool(torch.isfinite(out[0]).all())
    torch.testing.assert_close(out[0], ref[0], rtol=5e-5, atol=5e-5)
    if need_iface:
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        assert out[1].sum() > 0 and out[2].sum() > 0
    else:
        assert out[1] is None and out[2] is None
    again = ev.elec_vdw_pairs(*args, **kw)
    assert torch.equal(again[0], out[0])          # deterministic sums


@pytest.mark.parametrize("lig_x,nan", [(1e-2, False), (0.0, True)])
def test_elec_vdw_kernel_coincident_pair(cuda, lig_x, nan):
    """d2 -> 0 clamps; d2 == 0 is NaN in the kernel as in its plain
    version (the clamps must not be fminf/fmaxf)."""
    def vec(v):
        return torch.full((1,), v, dtype=torch.float32, device=cuda)

    rec = torch.zeros((1, 1, 3), dtype=torch.float32, device=cuda)
    lig = torch.tensor([[[lig_x], [0.0], [0.0]]], dtype=torch.float32, device=cuda)
    ones = torch.ones((1, 1, 1), dtype=torch.int32, device=cuda)
    args = (rec, lig, vec(0.5), vec(0.5), vec(0.2), vec(0.2), vec(1.5), vec(1.5),
            ones, ones)
    out = ev.elec_vdw_pairs(*args, r_tile=32, l_tile=128)
    ref = ev.elec_vdw_pairs_plain(*args, r_tile=32, l_tile=128)
    if nan:
        assert torch.isnan(out[0]).all() and torch.isnan(ref[0]).all()
    else:
        torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)
        assert torch.isfinite(out[0]).all()
    assert torch.equal(out[1], ref[1]) and out[1].sum() == 1


def test_dna_anm_energy_fn_on_card_matches_cpu(cuda):
    params, pos, _ = toy_system(300, 170, 37, num_anm=2, seed=4, method="dna")
    params = kernel_params(params)
    pose = [pos[:, :3], pos[:, 3:7], pos[:, 7:9], pos[:, 9:11]]
    out = {}
    for dev in ("cpu", cuda):
        fn = make_kernel_energy_fn(params, dev, torch.float32)
        tp = torch_params(params, dev, torch.float32)
        out[str(dev)] = fn(tp, *(torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev) for x in pose))
    assert torch.isfinite(out["cuda"]).all()
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("worklist", [False, True])
def test_dfire_anm_energy_fn_on_card_matches_cpu(cuda, worklist):
    """DFIRE with ANM on both sides, through K1 or K2, on the card against
    the CPU (the plain versions)."""
    params, pos, _ = toy_system(300, 170, 37, num_anm=2, seed=4)
    params = kernel_params(params)
    pose = [pos[:, :3], pos[:, 3:7], pos[:, 7:9], pos[:, 9:11]]
    out = {}
    for dev in ("cpu", cuda):
        fn = make_kernel_energy_fn(params, dev, torch.float32, worklist=worklist)
        tp = torch_params(params, dev, torch.float32)
        out[str(dev)] = fn(tp, *(torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev) for x in pose))
    assert torch.isfinite(out["cuda"]).all()
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-5, atol=5e-5)


def _v1_kernel_args(dev, g, method, num_anm, seed=3):
    """The v1 kernel's inputs for ``g`` poses clustered by chunk (some
    tiles culled by the energy path's box cull), per-pose interface bits
    seeded at random; a per-pose receptor with ``num_anm`` > 0."""
    params, pos, _ = toy_system(300, 170, g, num_anm=num_anm, seed=seed,
                                method=method, dfire_mode="steps")
    params = kernel_params(params, "v1")
    fn = make_kernel_energy_fn(params, dev, torch.float32, kernel="v1")
    tp = torch_params(params, dev, torch.float32)
    rng = np.random.RandomState(seed)
    n_c = -(-g // dp.POSE_BLOCK)
    t = (np.repeat(rng.uniform(-35, 35, (n_c, 3)), dp.POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3)))

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    args, kwargs = fn.kernel_args(
        tp, tensor(t), tensor(pos[:, 3:7]), tensor(pos[:, 7:7 + num_anm]),
        tensor(pos[:, 7 + num_anm:]))
    act = args[-2]
    assert 0 < int(act.sum()) < act.numel()      # some tile-poses are culled
    iface = torch.as_tensor((rng.rand(*act.shape) < 0.7).astype(np.int32), device=dev)
    return args[:-1] + (iface,), kwargs


def _check_v1(kernel, plain, args, kwargs, need_iface, rtol=5e-5):
    kw = dict(kwargs, need_iface=need_iface)
    before = kernel.launches
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(*args, **kw)
    assert bool(torch.isfinite(out[0]).all())
    torch.testing.assert_close(out[0], ref[0], rtol=rtol, atol=5e-5)
    if need_iface:
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        assert out[1].sum() > 0 and out[2].sum() > 0
    else:
        assert out[1] is None and out[2] is None
    again = kernel(*args, **kw)
    assert torch.equal(again[0], out[0])          # deterministic sums


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("need_iface", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_k4_matches_plain(cuda, g, num_anm, need_iface, bf16):
    """K4 (step-form DFIRE, per-pose bits) against its plain version, rigid
    and per-pose receptor, float32 and bfloat16 step tables."""
    args, kwargs = _v1_kernel_args(cuda, g, "dfire", num_anm)
    assert args[0].shape[0] == (g if num_anm else 1)
    if bf16:
        args = args[:2] + (args[2].to(torch.bfloat16),) + args[3:]
    _check_v1(k4.dfire_pairs_v1, k4.dfire_pairs_v1_plain, args, kwargs, need_iface)


@pytest.mark.parametrize("per_pose", [False, True])
def test_k4_at_bin_edges(cuda, per_pose):
    """Pairs on every 0.5 A slot edge and within 64 ulps either side, the
    interface cutoff's too (the step-table form of
    ``standin.bin_edge_case``, where a pair binned one off moves its pose's
    sum by at least 1): K4, rigid and per-pose receptor, equals its plain
    version exactly, sums and flags."""
    args, kwargs = standin.bin_edge_case(cuda, per_pose=per_pose, ulps=64).k4
    before = k4.dfire_pairs_v1.launches
    out = k4.dfire_pairs_v1(*args, **kwargs)
    torch.cuda.synchronize()
    assert k4.dfire_pairs_v1.launches == before + 1
    ref = k4.dfire_pairs_v1_plain(*args, **kwargs)
    for ours, theirs in zip(out, ref):
        assert torch.equal(ours, theirs)
    assert out[1].sum() > 0 and out[2].sum() > 0


@pytest.mark.parametrize("r_tile,l_tile", [(16, 64), (32, 32), (24, 16)])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("g", [45, 200])
def test_k4_other_tiles(cuda, r_tile, l_tile, num_anm, g):
    """K4 on tiles other than the path's 32 x 128 (at most 32 receptor rows,
    ligand tiles a multiple of 16 atoms), rigid and per-pose receptor, G a
    multiple of the 16-pose chunk or not, against its plain version with
    seeded bits; 40 rows or a 24-atom ligand tile are refused."""
    args, _ = _v1_kernel_args(cuda, g, "dfire", num_anm)
    rng = np.random.RandomState(r_tile + l_tile)

    def bits(r, l):
        shape = (-(-args[0].shape[1] // r), -(-args[1].shape[2] // l), g)
        return torch.as_tensor((rng.rand(*shape) < 0.7).astype(np.int32), device=cuda)

    a = args[:4] + (bits(r_tile, l_tile), bits(r_tile, l_tile))
    _check_v1(k4.dfire_pairs_v1, k4.dfire_pairs_v1_plain, a,
              dict(r_tile=r_tile, l_tile=l_tile), True)
    for r, l in ((40, 128), (32, 24)):
        with pytest.raises(ValueError, match="unsupported tile"):
            k4.dfire_pairs_v1(*args[:4], bits(r, l), bits(r, l), r_tile=r, l_tile=l)


@pytest.mark.parametrize("num_anm", [0, 2])
def test_k4_pose_groups_bit_equal(cuda, num_anm):
    """The kernel groups 16-pose chunks a block by the batch's size (on the
    H100: 11 of 400 chunks at 6,400 poses, 7 of 13 at 200, all 3 at 37).
    The grouping changes where a pose is scored, not how: the first 200
    and 37 poses of a 6,400-pose batch scored alone give their sums and
    flags bit for bit."""
    g = 6400
    args, kwargs = _v1_kernel_args(cuda, g, "dfire", num_anm)

    def first(n):
        rec = args[0] if args[0].shape[0] == 1 else args[0][:n]
        return (rec, args[1][:n], args[2], args[3], args[4][..., :n].contiguous(),
                args[5][..., :n].contiguous())

    whole = k4.dfire_pairs_v1(*args, **kwargs)
    for n in (200, 37):
        out = k4.dfire_pairs_v1(*first(n), **kwargs)
        for ours, theirs in zip(out, whole):
            assert torch.equal(ours, theirs[:n])
    ref = k4.dfire_pairs_v1_plain(*first(200), **kwargs)
    torch.testing.assert_close(whole[0][:200], ref[0], rtol=5e-5, atol=5e-5)
    assert torch.equal(whole[1][:200], ref[1]) and torch.equal(whole[2][:200], ref[2])


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("need_iface", [True, False])
def test_k5_matches_plain(cuda, g, num_anm, need_iface):
    """K5 (elec/vdw, per-pose bits) against its plain version, rigid and
    per-pose receptor."""
    args, kwargs = _v1_kernel_args(cuda, g, "dna", num_anm)
    _check_v1(k5.elec_vdw_pairs_v1, k5.elec_vdw_pairs_v1_plain, args, kwargs,
              need_iface)


def test_k5_coincident_pair(cuda):
    """d2 == 0 is NaN in K5 as in its plain version."""
    def vec(v):
        return torch.full((1,), v, dtype=torch.float32, device=cuda)

    ones = torch.ones((1, 1, 1), dtype=torch.int32, device=cuda)
    args = (torch.zeros((1, 1, 3), device=cuda), torch.zeros((1, 3, 1), device=cuda),
            vec(0.5), vec(0.5), vec(0.2), vec(0.2), vec(1.5), vec(1.5), ones, ones)
    out = k5.elec_vdw_pairs_v1(*args, r_tile=32, l_tile=128)
    ref = k5.elec_vdw_pairs_v1_plain(*args, r_tile=32, l_tile=128)
    assert torch.isnan(out[0]).all() and torch.isnan(ref[0]).all()
    assert torch.equal(out[1], ref[1]) and out[1].sum() == 1


@pytest.mark.parametrize("method,num_anm", [("dfire", 0), ("dna", 2)])
def test_v1_energy_fn_on_card_matches_cpu(cuda, method, num_anm):
    params, pos, _ = toy_system(300, 170, 37, num_anm=num_anm, seed=4,
                                method=method, dfire_mode="steps")
    params = kernel_params(params, "v1")
    k = num_anm
    pose = [pos[:, :3], pos[:, 3:7], pos[:, 7:7 + k], pos[:, 7 + k:]]
    out = {}
    for dev in ("cpu", cuda):
        fn = make_kernel_energy_fn(params, dev, torch.float32, kernel="v1")
        tp = torch_params(params, dev, torch.float32)
        out[str(dev)] = fn(tp, *(torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev) for x in pose))
    assert torch.isfinite(out["cuda"]).all()
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("probe", sorted(probes.SCRIPTS))
def test_probe_kernels_match_plain(cuda, probe):
    """Every variant of a probe (P1 with 40 reps, the rest at the scripts'
    shapes): its kernel template (select_reps, receptor_loop or
    gather_form) against its plain version on the card, bit for bit (the
    plain versions repeat the kernels' order); one launch a call; two
    launches bit-equal."""
    mod = probes.load(probe)
    arrays = mod.inputs()
    variants = mod.variants(arrays, reps=40) if probe == "P1" else mod.variants(arrays)
    for v in variants:
        t = v.tensors(arrays, cuda)
        before = v.counter.launches
        out = v(t)
        torch.cuda.synchronize()
        assert v.counter.launches == before + 1, v.name
        ref = v.plain(t)
        assert out.dtype == ref.dtype and out.shape == ref.shape, v.name
        assert torch.isfinite(out.float()).all(), v.name
        assert torch.equal(out, ref), (v.name, float((out.float() - ref.float()).abs().max()))
        assert torch.equal(v(t), out), v.name


def _select_case(variant, p, reps, d2, tab):
    """select_reps on the card against its plain version, bit for bit; one
    counted launch a call; two launches bit-equal.  Returns the output."""
    mode = "chain" if variant == "chain16" else variant
    thr = probes.load("P1").THRESH
    before = ops_probes.select_reps.launches
    out = ops_probes.select_reps(d2, tab, thr, mode, reps)
    torch.cuda.synchronize()
    assert ops_probes.select_reps.launches == before + 1
    ref = ops_probes.select_reps_plain(d2, tab, thr, mode, reps)
    assert out.shape == (p, 1, 1) and out.dtype == d2.dtype
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
    assert torch.equal(ops_probes.select_reps(d2, tab, thr, mode, reps), out)
    return out


@pytest.mark.parametrize("reps", [1, 31, 33, 400])
@pytest.mark.parametrize("rl", [256, 768, 8192])
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("variant", ["chain", "tak", "tourn", "chain16"])
def test_select_reps_ragged(cuda, variant, p, rl, reps):
    """P1's kernel bit-equal to its plain version at ragged shapes: one to
    32 element blocks of 256 (R L = 256, 768, 8,192), 1, 3 and 8 poses, and
    reps that leave a ragged batch of 8 (1, 31, 33) or split into chunks
    over the grid (400), for the three f32 forms and chain16 (bfloat16,
    two reps a bf16x2 register); d2 and tab as P1's inputs draw them."""
    arrays = probes.load("P1").inputs((rl + p, reps), P=p, R=rl // 256, L=256)
    dt = torch.bfloat16 if variant == "chain16" else torch.float32
    d2, tab = (torch.as_tensor(arrays[k], dtype=torch.float32).to(device=cuda, dtype=dt)
               for k in ("d2", "tab"))
    _select_case(variant, p, reps, d2, tab)


def test_select_reps_chain16_subnormals(cuda):
    """chain16 on a table of bfloat16 subnormals and zeros of both signs,
    with d2 holding some zeros and subnormals too: every packed add,
    compare, select and mask multiply meets them, and the output, a sum of
    subnormals, is nonzero only where none is flushed.  Bit-equal to plain.
    (A zero term's sign cannot reach the output: the rep sum starts from
    +0.)"""
    rng = np.random.RandomState(5)
    p, reps = 3, 33
    sub = np.concatenate([np.arange(0x0000, 0x0080), np.arange(0x8000, 0x8080)])
    tab = rng.choice(sub, (21, 3, 256)).astype(np.int16)
    d2 = torch.as_tensor(rng.uniform(0, 400, (p, 3, 256)), dtype=torch.float32).to(torch.bfloat16)
    tiny = rng.rand(p, 3, 256) < 0.125
    d2.view(torch.int16)[torch.as_tensor(tiny)] = torch.as_tensor(
        rng.choice(sub, int(tiny.sum())).astype(np.int16))
    tab = torch.as_tensor(tab).view(torch.bfloat16)
    out = _select_case("chain16", p, reps, d2.to(cuda), tab.to(cuda))
    assert (out.float().abs() > 0).all() and (out.float().abs() < 2.0 ** -100).all()


@pytest.mark.parametrize("span", [20.0, 6.0])
@pytest.mark.parametrize("p", [1, 3, 128])
@pytest.mark.parametrize("r", [1, 17, 1633])
@pytest.mark.parametrize("l", [37, 300])
@pytest.mark.parametrize("mode", ["slot", "gather", "chain"])
def test_receptor_loop_ragged(cuda, mode, l, r, p, span):
    """The receptor loop bit-equal to its plain version at ragged shapes:
    a partial tile of 8 ligand atoms (37, 300) and of 8 poses (1, 3), a
    batch's ragged tail (17 and 1,633 receptor atoms; one atom), and both
    of the kernel's block sizes (1,024 threads at up to one tile an SM,
    256 at 608 tiles); at the scripts' geometry (uniform(-20, 20)) and the
    compact one (uniform(-6, 6), every slot, threshold and the cutoff
    crossed).  One launch a call; two launches bit-equal."""
    arrays = probes.load("P2").inputs(seed=r + l, P=p, L=l, R=r, span=span)
    t = {k: torch.as_tensor(a, dtype=torch.float32, device=cuda) for k, a in arrays.items()}
    thr = probes.load("P2").THRESH
    before = ops_probes.receptor_loop.launches
    out = ops_probes.receptor_loop(t["lig"], t["rec"], t["tab"], thr, mode)
    torch.cuda.synchronize()
    assert ops_probes.receptor_loop.launches == before + 1
    ref = ops_probes.receptor_loop_plain(t["lig"], t["rec"], t["tab"], thr, mode)
    assert out.shape == (p, l) and torch.isfinite(out).all()
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert torch.equal(ops_probes.receptor_loop(t["lig"], t["rec"], t["tab"], thr, mode), out)


@pytest.mark.parametrize("reps", [1, 7, 64, 65])
@pytest.mark.parametrize("form", ["static_loop", "slice_loop", "row_loop", "parity_loop",
                                  "chain_loop", "scalar_loop"])
def test_gather_form_loops_any_reps(cuda, form, reps):
    """The loop forms bit-equal to the plain loop at 1, 7, 64 and 65 reps,
    on 37 x 256 elements (a ragged last block): the heavy terms (slot
    gathers, the chain) above one rep through the kernel that spreads
    (element, rep) terms over threads and adds them in rep order (65: two
    passes of terms for an element), the rest one thread an element."""
    gen = torch.Generator(device=cuda).manual_seed(reps)
    x = torch.rand((37, 256), generator=gen, device=cuda) * 200
    tab = torch.randn((70, 32, 256), generator=gen, device=cuda)
    rec = torch.randn((70, 3), generator=gen, device=cuda)
    kw = dict(thresholds=probes.load("P2").THRESH) if form == "chain_loop" else {}
    args = dict(x=x, rec=rec) if form == "scalar_loop" else dict(x=x, tab=tab)
    before = ops_probes.gather_form.launches
    out = ops_probes.gather_form(form, **args, reps=reps, **kw)
    torch.cuda.synchronize()
    assert ops_probes.gather_form.launches == before + 1
    assert torch.equal(out, ops_probes.gather_form_plain(form, **args, reps=reps, **kw))


def test_bare_gather_clips_on_card(cuda):
    """Out-of-range indices of the bare gather are clipped on the card as
    in the plain version."""
    tab = torch.randn((32, 256), device=cuda)
    idx = torch.randint(-40, 72, (32, 256), dtype=torch.int32, device=cuda)
    out = ops_probes.gather_form("bare", tab=tab, idx=idx)
    assert torch.equal(out, ops_probes.gather_form_plain("bare", tab=tab, idx=idx))


@pytest.mark.parametrize("kernel", ["dfire_pairs", "dfire_pairs_worklist"])
@pytest.mark.parametrize("per_pose", [False, True])
def test_dfire_kernels_at_bin_edges(cuda, kernel, per_pose):
    """Pairs on every 0.5 A slot edge and within 64 ulps either side, the
    interface cutoff's too (``standin.bin_edge_case``, where a pair binned
    one off moves its pose's sum by at least 1; the band the CPU model of
    the slot covers): K1 and K2, rigid and per-pose receptor, equal their
    plain versions at 5e-5 with equal flags."""
    case = standin.bin_edge_case(cuda, per_pose=per_pose, ulps=64)
    fn, plain = getattr(dp, kernel), getattr(dp, kernel + "_plain")
    before = fn.launches
    out = fn(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(*case.args, **case.kwargs)
    torch.testing.assert_close(out[0], ref[0], rtol=5e-5, atol=5e-5)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    assert out[1].sum() > 0 and out[2].sum() > 0


@pytest.mark.parametrize("kernel", ["elec_vdw_pairs", "elec_vdw_pairs_v1"])
@pytest.mark.parametrize("per_pose", [False, True])
def test_elec_vdw_kernels_at_cutoff_edges(cuda, kernel, per_pose):
    """Pairs on the interface (3.9^2), vdw (10^2) and elec (30^2) cutoffs
    and within 64 ulps either side (``standin.cutoff_edge_case``, where a
    mask one off moves its pose's sum far beyond 5e-5): K3 and K5, rigid
    and per-pose receptor, equal their plain versions at 5e-5, score
    nothing exactly where plain scores nothing, and flag the same atoms."""
    case = standin.cutoff_edge_case(cuda, per_pose=per_pose, ulps=64)
    mod = ev if kernel == "elec_vdw_pairs" else k5
    fn, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
    args, kwargs = case.k3 if mod is ev else case.k5
    before = fn.launches
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(*args, **kwargs)
    torch.testing.assert_close(out[0], ref[0], rtol=5e-5, atol=5e-5)
    assert torch.equal(out[0] == 0, ref[0] == 0) and int((ref[0] == 0).sum()) == 64
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    assert out[1].sum() > 0 and out[2].sum() > 0


@pytest.mark.parametrize("r_tile,l_tile", [(16, 64), (32, 32)])
@pytest.mark.parametrize("num_anm", [0, 2])
def test_elec_vdw_kernels_other_tiles(cuda, r_tile, l_tile, num_anm):
    """K3 and K5 on tiles other than the path's 32 x 128 (at most 32
    receptor rows; 32, 64 or 128 ligand atoms), rigid and per-pose
    receptor, against their plain versions with seeded bits; a ligand
    tile of 256 atoms is refused."""
    args, _ = _clustered_kernel_args(cuda, 37, method="dna", num_anm=num_anm)
    g = args[1].shape[0]
    rng = np.random.RandomState(5)

    def bits(r, l, n):
        shape = (-(-args[0].shape[1] // r), -(-args[1].shape[2] // l), n)
        return torch.as_tensor((rng.rand(*shape) < 0.7).astype(np.int32), device=cuda)

    n_c = -(-g // dp.POSE_BLOCK)
    for mod, kernel, chunks in ((ev, ev.elec_vdw_pairs, n_c), (k5, k5.elec_vdw_pairs_v1, g)):
        plain = getattr(mod, kernel.__name__ + "_plain")
        a = args[:8] + (bits(r_tile, l_tile, chunks), bits(r_tile, l_tile, g))
        out = kernel(*a, r_tile=r_tile, l_tile=l_tile)
        ref = plain(*a, r_tile=r_tile, l_tile=l_tile)
        torch.testing.assert_close(out[0], ref[0], rtol=5e-5, atol=5e-5)
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        assert out[1].sum() > 0
        wide = args[:8] + (bits(32, 256, chunks), bits(32, 256, g))
        with pytest.raises(ValueError, match="unsupported tile"):
            kernel(*wide, r_tile=32, l_tile=256)


def test_host_engine_on_card_matches_cpu(cuda, tmp_path):
    """``GsoHostEngine`` with its energies on the card: gso_1.out the CPU
    run's text, and the state after 10 steps within 1e-9 of the CPU's (the
    float64 sums run in another order there), neighbour counts equal."""
    setup, positions = standin.write_complex(tmp_path, "dna", 200, 80, 30, num_anm=2,
                                             seed=7)
    sim = load_simulation(setup, positions[0], "dna", anm_dir=tmp_path)
    runs = {}
    for device in (cuda, torch.device("cpu")):
        out = tmp_path / device.type
        out.mkdir()
        engine = GsoHostEngine(sim.batch_params(), sim.positions, sim.seed, sim.use_anm,
                               sim.setup.anm_rec, sim.setup.anm_lig,
                               output_directory=str(out), device=device)
        engine.run(10)
        runs[device.type] = engine
    assert (tmp_path / "cuda" / "gso_1.out").read_text() == \
        (tmp_path / "cpu" / "gso_1.out").read_text()
    card, cpu = runs["cuda"], runs["cpu"]
    for name in ("t", "q", "a_rec", "a_lig", "luciferin", "scoring", "vision"):
        np.testing.assert_allclose(getattr(card, name), getattr(cpu, name), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert np.array_equal(card.num_neighbors, cpu.num_neighbors)
