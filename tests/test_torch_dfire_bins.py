"""How the DFIRE pair kernels K1, K2 and K4 bin a pair, and the table they
read, on the CPU.

The kernels take a pair's 0.5 A slot from its distance, m = trunc(2 s (1
+ 2^-16) - 1) with s the hardware's approximate float32 sqrt, corrected
by one compare against the exact edge ((m + 1) / 2)^2, then the slot's
bin from ``slot_bins``; the plain versions (and the JAX kernels) count
the thresholds at or below d2.  A torch mirror of the kernels' float32
arithmetic, for every float32 sqrt within 64 ulps of the correctly
rounded one (taken in float64 and rounded: PyTorch's float32 sqrt on the
CPU is not always correctly rounded), must equal the count near every
edge; so must the edge compare applied to the correctly rounded sqrt,
which alone rounds onto seven live thresholds from 1 ulp below.  The
per-type table must hold the per-atom table's values bit for bit, and
the plain versions must match the JAX kernel on pairs placed on the
edges.  K4 reads the slot's channel of a pair's prefix sums, which must
equal the plain version's select chain there bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lightdock_tpu.ops import pallas_energy as pe  # noqa: E402
from lightdock_tpu_torch import constants as C  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import kernel_params  # noqa: E402
from lightdock_tpu_torch.engine.params import (  # noqa: E402
    dfire_bin_thresholds, torch_params)
from lightdock_tpu_torch.ops import dfire_pairs as dp  # noqa: E402
from lightdock_tpu_torch.ops import dfire_pairs_v1 as k4  # noqa: E402
from lightdock_tpu_torch.ops.tiling import dfire_live_channels  # noqa: E402
from lightdock_tpu_torch.scoring import tables as score_tables  # noqa: E402

ULPS = 64


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _live_thresholds():
    thr = dfire_bin_thresholds(score_tables.dfire_tables()["dist_to_bins"])
    return tuple(float(thr[k]) for k in dfire_live_channels(thr))


def _around(values, ulps=ULPS):
    """float32 values within ``ulps`` ulps of each positive value."""
    bits = np.asarray(values, np.float32).view(np.int32)
    near = bits[:, None] + np.arange(-ulps, ulps + 1, dtype=np.int32)[None, :]
    return near.reshape(-1).view(np.float32)


def _threshold_bins(d2, thresholds):
    """The plain versions' bin: the thresholds after the first at or below
    d2."""
    return sum((d2 >= t).to(torch.int64) for t in thresholds[1:])


def _sqrt_rn(d2):
    return torch.sqrt(d2.double()).float()


def _slot(d2, corrected=True, s=None):
    """The slot m in float32, with or without the edge compare: from the
    correctly rounded sqrt, trunc(2 s - 1), or with ``s`` (a float32 sqrt
    of d2) the kernels' form, 2 s (1 + 2^-16) - 1 in one fma (exact in
    float64, then rounded once)."""
    if s is None:
        m = (_sqrt_rn(d2) * 2.0 - 1.0).to(torch.int32)   # __float2int_rz
    else:
        m = (s.double() * (2.0 + 2.0 ** -15) - 1.0).float().to(torch.int32)
    if corrected:
        edge = (m + 1).float() * 0.5
        m = torch.where(d2 < edge * edge, m - 1, m)
    return m


def _kernel_bins(d2, thresholds, corrected=True, s=None):
    table = torch.tensor(dp.slot_bins(thresholds), dtype=torch.int64)
    return table[(_slot(d2, corrected, s) + 1).long()]


def _edge_d2():
    """float32 d2 within 64 ulps of every live threshold and slot edge
    under the cutoff, 0 and the cutoff; and the live thresholds."""
    thr = _live_thresholds()
    edges = [((s + 1) / 2.0) ** 2 for s in range(30)]
    d2 = np.unique(np.concatenate([_around([t for t in thr if t > 0] + edges),
                                   np.float32([0.0, C.DFIRE_DIST_CUTOFF2])]))
    return torch.as_tensor(d2[d2 <= C.DFIRE_DIST_CUTOFF2]), thr


def test_slot_mirror_equals_threshold_count():
    """Within 64 ulps of every live threshold and every slot edge under the
    cutoff, at d2 = 0 and at the 225 cutoff, the corrected slot gives the
    threshold count's bin.  Without the edge compare the slot is one too
    high 1 ulp below seven live thresholds, where the sqrt rounds up onto
    the half-angstrom."""
    d2, thr = _edge_d2()
    assert len(thr) == 21 and thr[0] == 0.0 and thr[-1] == C.DFIRE_DIST_CUTOFF2
    assert d2.numel() == 30 * (2 * ULPS + 1) - ULPS + 1   # 225 + k ulps are out
    expected = _threshold_bins(d2, thr)
    assert torch.equal(_kernel_bins(d2, thr), expected)
    wrong = _kernel_bins(d2, thr, corrected=False) != expected
    below = {float(np.nextafter(np.float32(t), np.float32(0))): t for t in thr[1:]}
    assert sorted(below[float(x)] for x in d2[wrong]) == [
        6.25, 20.25, 25.0, 30.25, 81.0, 100.0, 121.0]


def test_approximate_sqrt_slot_equals_threshold_count():
    """The kernels' form: for every float32 sqrt within 64 ulps of the
    correctly rounded one (the PTX ISA bounds sqrt.approx.f32's relative
    error by 2^-23, a few ulps), the scaled slot is the exact slot or one
    above it, and the edge compare gives the threshold count's bin, near
    every edge as above."""
    d2, thr = _edge_d2()
    expected = _threshold_bins(d2, thr)
    exact = _slot(d2)
    bits = _sqrt_rn(d2).view(torch.int32)
    for k in range(-ULPS, ULPS + 1):
        s = torch.where(d2 > 0, bits + k, bits).view(torch.float32)
        assert torch.equal(_kernel_bins(d2, thr, s=s), expected), k
        up = _slot(d2, corrected=False, s=s) - exact
        assert bool(((up == 0) | (up == 1)).all()), k


@pytest.mark.parametrize("wrapper", [dp.dfire_pairs, dp.dfire_pairs_worklist,
                                     k4.dfire_pairs_v1])
def test_wrappers_refuse_off_grid_thresholds(wrapper):
    """A live threshold that is not 0 or a slot edge ((m + 1) / 2)^2 cannot
    be binned by slot: the wrapper raises, on the CPU as on the card (K4
    takes its thresholds beside the step tables, K1 and K2 in theirs)."""
    case = standin.bin_edge_case()
    tab = case.args[2]
    off = tab.thresholds[:2] + (6.3,) + tab.thresholds[3:]
    if wrapper is k4.dfire_pairs_v1:
        args, kwargs = case.k4
        with pytest.raises(ValueError, match="slot"):
            wrapper(*args[:3], off, *args[4:], **kwargs)
        with pytest.raises(ValueError, match="slot"):   # an unreachable bin's +inf
            wrapper(*args[:3], args[3][:-1] + (float("inf"),), *args[4:], **kwargs)
    else:
        bad = tab._replace(thresholds=off)
        with pytest.raises(ValueError, match="slot"):
            wrapper(case.args[0], case.args[1], bad, *case.args[3:], **case.kwargs)
    assert dp.slot_bins(tab.thresholds)[:7] == (0, 0, 0, 0, 1, 2, 3)


def _select_chain(d2, dq, thresholds):
    """The plain K4's value of a pair: dq[0], then dq[k] added where
    d2 >= s_k, in channel order (dq (K, n) float32, one column a pair)."""
    contrib = dq[0].clone()
    for k in range(1, len(thresholds)):
        contrib = torch.where(d2 >= thresholds[k], contrib + dq[k], contrib)
    return contrib


def test_k4_slot_channel_equals_select_chain():
    """K4's form: the pair's prefix sums of its step-table channels,
    formed in float32 in channel order, read at the slot's channel
    (``slot_bins`` of the corrected slot from any float32 sqrt within 64
    ulps of the correctly rounded one) equal the select chain of the plain
    version bit for bit, near every live threshold and slot edge; each pair
    has its own random channels, so a channel one off shows."""
    d2, thr = _edge_d2()
    step = dfire_bin_thresholds(score_tables.dfire_tables()["dist_to_bins"])
    assert thr == tuple(float(t) for t in step[step <= C.DFIRE_DIST_CUTOFF2])
    rng = np.random.RandomState(8)
    dq = torch.as_tensor(rng.standard_normal((len(thr), d2.numel())).astype(np.float32))
    prefix = dq.clone()   # the kernel's prefix sums: float32, in channel order
    for k in range(1, len(thr)):
        prefix[k] = prefix[k - 1] + dq[k]
    expected = _select_chain(d2, dq, thr)
    assert len(set(expected.tolist())) > len(thr)
    bits = _sqrt_rn(d2).view(torch.int32)
    cols = torch.arange(d2.numel())
    for k in range(-ULPS, ULPS + 1):
        s = torch.where(d2 > 0, bits + k, bits).view(torch.float32)
        channel = _kernel_bins(d2, thr, s=s)
        assert torch.equal(prefix[channel, cols], expected), k


@pytest.mark.parametrize("per_pose", [False, True])
def test_k4_bin_edge_case_plain_matches_pallas(per_pose):
    """The step-table form of ``standin.bin_edge_case`` (the same pairs,
    channels whose prefix sum at channel k is the table's entry for bin k):
    the plain K4 equals ``dfire_pairs_pallas`` in interpret mode (rtol
    5e-6, flags exact; a rigid receptor broadcast for the JAX kernel, as
    its energy path does) and the plain K1 on the same pairs exactly."""
    case = standin.bin_edge_case(per_pose=per_pose)
    (rec, lig, dq, thr, act, iface), kwargs = case.k4
    g = lig.shape[0]
    ref = jax.jit(lambda *a: pe.dfire_pairs_pallas(
        *a[:3], thr, *a[3:], interpret=True, r_tile=32, l_tile=128))(
        jnp.asarray(rec.expand(g, -1, -1).numpy()), jnp.asarray(lig.numpy()),
        jnp.asarray(dq.numpy()), jnp.asarray(act.numpy()), jnp.asarray(iface.numpy()))
    out = k4.dfire_pairs_v1(*case.k4[0], **kwargs)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=5e-6, atol=0)
    for ours, theirs in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs)[:, :ours.shape[1]])
    k1 = dp.dfire_pairs(*case.args, **case.kwargs)
    for ours, theirs in zip(out, k1):
        assert torch.equal(ours, theirs)
    assert int(out[1].sum()) > 0 and int((out[0] > 0).sum()) < g   # flags; 225 + 1 ulp is out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_per_type_table_equals_per_atom_table(dtype):
    """The table by receptor row class, gathered by ``rec_type``, holds the
    per-atom table's values bit for bit (the same ascending prefix sum of
    the same delta rows), and padding atoms read zeros."""
    params, _, _ = standin.toy_system(300, 170, 2, seed=5)
    params = kernel_params(params)
    tp = torch_params(params, "cpu", dtype)
    tab = dp.dfire_tables(tp.dfire_rec_half, tp.dfire_lig_onehot,
                          params.dfire_thresholds, 32, 128)
    live = dfire_live_channels(tuple(float(x) for x in params.dfire_thresholds))
    rec_half = tp.dfire_rec_half
    k, nr, n_types = rec_half.shape
    per_atom = torch.zeros((nr, n_types, dp.MAX_CHANNELS), dtype=dtype)
    acc = rec_half[live[0]]
    per_atom[:, :, 0] = acc
    for i in range(1, len(live)):
        acc = acc + rec_half[live[i]]
        per_atom[:, :, i] = acc
    rt = tab.rec_type.long()
    assert tab.cum.dtype == dtype and tab.rec_type.dtype == torch.int32
    assert torch.equal(tab.cum[rt[:nr], :n_types], per_atom)
    assert rt.shape[0] == 320 and (rt[nr:] == tab.cum.shape[0] - 1).all()
    assert not tab.cum[-1].any() and not tab.cum[:, -1].any()
    assert tab.cum.shape[0] == len(np.unique(params.atom_types_rec)) + 1


@pytest.mark.parametrize("per_pose", [False, True])
def test_bin_edge_case_plain_matches_pallas(per_pose):
    """The pairs of ``standin.bin_edge_case`` sit at their d2 in float32,
    and there the plain K1 and K2 equal the JAX kernel in interpret mode
    (rtol 5e-6, flags exact)."""
    case = standin.bin_edge_case(per_pose=per_pose)
    rec, lig = case.args[0], case.args[1]
    g = lig.shape[0]
    rows = torch.arange(g) if per_pose else torch.zeros(g, dtype=torch.int64)
    near = rec[rows, (7 * torch.arange(g)) % 32 if per_pose else 5]   # (G, 3)
    d = [lig[:, c, 0] - near[:, c] for c in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    assert torch.equal(d2, torch.as_tensor(case.d2))
    thr = case.args[2].thresholds
    ref = jax.jit(lambda *a: pe.dfire_pairs_pallas_v2(
        *a[:4], thr, *a[4:], interpret=True, r_tile=32, l_tile=128,
        need_iface=True, p_block=dp.POSE_BLOCK))(
        jnp.asarray(rec.numpy()), jnp.asarray(lig.numpy()),
        jnp.asarray(case.rec_half.numpy()), jnp.asarray(case.lig_onehot.numpy()),
        jnp.asarray(case.args[3].numpy()), jnp.asarray(case.args[4].numpy()))
    for fn in (dp.dfire_pairs, dp.dfire_pairs_worklist):
        out = fn(*case.args, **case.kwargs)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=5e-6, atol=0)
        for ours, theirs in zip(out[1:], ref[1:]):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    bins = _threshold_bins(torch.as_tensor(case.d2), thr)
    inside = torch.as_tensor(case.d2) <= C.DFIRE_DIST_CUTOFF2
    assert torch.equal(out[0] > 0, inside)           # 225 + 1 ulp scores nothing
    assert len(set(bins[inside].tolist())) == len(thr)   # every bin is hit
