"""The elec/vdw kernels' approximate reciprocal, modelled on the CPU.

The Hopper kernels K3 and K5 (``csrc/elec_vdw_body.cuh``) take 1/d2 from
the hardware's ``rcp.approx.ftz.f32``, within an ulp or two of the
correctly rounded reciprocal that the plain versions and the JAX kernels
take; d2, and with it every cutoff mask and interface flag, stays exact.
A torch model of the kernels' float32 arithmetic with every finite 1/d2
moved by 2 ulps (up, down, or each way by a seeded sign) must give raw
sums within the DNA/PYDOCK tolerance, rtol and atol 5e-5, of
``elec_vdw_pairs_pallas_v2`` (K3's function) and ``elec_vdw_pairs_pallas``
(K5's) in Pallas interpret mode, with the same interface flags; unmoved,
it must equal the plain versions bit for bit, which shows it is their
arithmetic.  At d2 == 0 the reciprocal stays +inf, so a coincident pair
still gives NaN.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lightdock_tpu.ops import pallas_energy as pe  # noqa: E402
from lightdock_tpu_torch import constants as C  # noqa: E402
from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import torch_params  # noqa: E402
from lightdock_tpu_torch.ops import elec_vdw_pairs as ev  # noqa: E402
from lightdock_tpu_torch.ops import elec_vdw_pairs_v1 as k5  # noqa: E402
from lightdock_tpu_torch.ops.dfire_pairs import POSE_BLOCK  # noqa: E402
from lightdock_tpu_torch.ops.tiling import expand_pose_bits  # noqa: E402

TOL = dict(rtol=5e-5, atol=5e-5)
R_TILE, L_TILE = 32, 128
ULPS = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moved(inv, shift, seed):
    """``inv`` with every finite nonzero entry moved by ``shift`` ulps
    ("+", "-", or "seeded": each entry up or down by a seeded sign)."""
    if shift == "+":
        k = torch.full(inv.shape, ULPS, dtype=torch.int32)
    elif shift == "-":
        k = torch.full(inv.shape, -ULPS, dtype=torch.int32)
    else:
        signs = np.random.RandomState(seed).randint(0, 2, size=inv.shape) * 2 - 1
        k = torch.as_tensor(signs.astype(np.int32) * ULPS)
    moved = (inv.view(torch.int32) + k).view(torch.float32)
    return torch.where(torch.isfinite(inv) & (inv != 0), moved, inv)


def _model(args, near, shift, pose_bits, seed=0):
    """The kernels' function with their float32 arithmetic, 16 poses at a
    time, with 1/d2 moved by ``shift`` (None: unmoved): (raw, iface_rec,
    iface_lig), padded as the plain versions pad.  ``pose_bits``: K5's
    per-pose bits; else K3's chunk bits with ``near`` (or None)."""
    rec, lig, qr, ql, vcr, vcl, vrr, vrl, act, iface = args
    g, _, nl = lig.shape
    nr = rec.shape[1]
    gp = -(-g // POSE_BLOCK) * POSE_BLOCK
    n_r, n_l = -(-nr // R_TILE), -(-nl // L_TILE)
    pad = torch.nn.functional.pad
    lig = pad(pad(lig, (0, 0, 0, 0, 0, gp - g), value=1e6), (0, n_l * L_TILE - nl), value=-1e6)
    if rec.shape[0] != 1:
        rec = pad(rec, (0, 0, 0, 0, 0, gp - g), value=1e6)
    rec = pad(rec, (0, 0, 0, n_r * R_TILE - nr), value=1e6)
    qr, vcr, vrr = (pad(x, (0, n_r * R_TILE - nr), value=v) for x, v in
                    ((qr, 0.0), (vcr, 0.0), (vrr, 1.0)))
    ql, vcl, vrl = (pad(x, (0, n_l * L_TILE - nl), value=v) for x, v in
                    ((ql, 0.0), (vcl, 0.0), (vrl, 1.0)))
    iface = pad(iface, (0, gp - g))
    if pose_bits:
        act = pad(act, (0, gp - g))
    qq = qr[:, None] * ql[None, :]
    ve = torch.sqrt(vcr[:, None] * vcl[None, :])
    vr = vrr[:, None] + vrl[None, :]
    vr2 = vr * vr
    raw = torch.empty(gp)
    ifr = torch.zeros((gp, n_r * R_TILE))
    ifl = torch.zeros((gp, n_l * L_TILE))
    for c in range(gp // POSE_BLOCK):
        sl = slice(c * POSE_BLOCK, (c + 1) * POSE_BLOCK)
        lc = lig[sl]
        rc = rec if rec.shape[0] == 1 else rec[sl]
        dx = lc[:, None, 0, :] - rc[:, :, 0, None]
        dy = lc[:, None, 1, :] - rc[:, :, 1, None]
        dz = lc[:, None, 2, :] - rc[:, :, 2, None]
        d2 = dx * dx + dy * dy + dz * dz
        inv = torch.reciprocal(d2)
        if shift is not None:
            inv = _moved(inv, shift, seed + c)
        elec = torch.clamp(qq * inv, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF)
        elec = elec * (d2 <= C.ELEC_DIST_CUTOFF2).to(torch.float32)
        p2 = vr2 * inv
        p6 = p2 * p2 * p2
        vdw = torch.clamp(ve * (p6 * p6 - 2.0 * p6), max=C.VDW_CUTOFF)
        vdw = vdw * (d2 <= C.VDW_DIST_CUTOFF2).to(torch.float32)
        def mask(bits):   # (n_r, n_l, P) -> (P, Nr_pad, Nl_pad)
            return expand_pose_bits(bits, R_TILE, L_TILE)

        if pose_bits:
            gate = mask(act[:, :, sl])
            contrib = elec * ev.ELEC_SCALE + vdw
            flag = gate & mask(iface[:, :, sl])
        else:   # a chunk's bits hold for its 16 poses
            one = torch.ones((1, 1, POSE_BLOCK), dtype=torch.int32)
            gate = mask(act[:, :, c:c + 1] * one)
            near_c = (mask(near[:, :, c:c + 1] * one) if near is not None
                      else torch.ones_like(gate))
            contrib = torch.where(near_c, elec * ev.ELEC_SCALE + vdw, elec * ev.ELEC_SCALE)
            flag = gate & near_c & mask(iface[:, :, sl].amax(dim=-1, keepdim=True) * one)
        contrib = torch.where(gate, contrib, torch.zeros_like(contrib))
        tiles = contrib.reshape(POSE_BLOCK, n_r, R_TILE, n_l, L_TILE).sum(dim=(2, 4))
        raw[sl] = tiles.reshape(POSE_BLOCK, n_r * n_l).sum(dim=1)
        close = (d2 <= C.INTERFACE_CUTOFF2) & flag
        ifr[sl] = close.any(dim=2).to(torch.float32)
        ifl[sl] = close.any(dim=1).to(torch.float32)
    return raw[:g], ifr[:g], ifl[:g]


def _ulps_from_cutoffs(rec, lig):
    """The fewest float32 ulps between any pair's d2 (the kernels' float32
    sequence) and the interface, vdw or elec cutoff."""
    rec, lig = rec.numpy(), lig.numpy()
    fewest = np.inf
    for g in range(lig.shape[0]):
        d = lig[g][None] - (rec[0] if rec.shape[0] == 1 else rec[g])[:, :, None]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        for cut in (C.INTERFACE_CUTOFF2, C.VDW_DIST_CUTOFF2, C.ELEC_DIST_CUTOFF2):
            cut = np.float32(cut)
            fewest = min(fewest, float((np.abs(d2 - cut) / np.spacing(cut)).min()))
    return fewest


def _inputs(method, per_pose, pose_bits, g=37, seed=9):
    """The kernel's inputs from the port's energy path on a 300 x 170
    stand-in: poses clustered by chunk up to 45 A out, so some chunk-tiles
    are culled and some far; the energy path's own cull and near bits,
    interface bits seeded at random.  Returns (args, near bits or None).

    No pair's d2 lies within 8 ulps of a cutoff (the seed is chosen so):
    there the JAX kernels' float32 d2, which XLA may round otherwise, and
    the kernels' can fall on two sides of the cutoff, a difference of d2,
    not of the reciprocal (``standin.cutoff_edge_case`` puts pairs on the
    edges where both round alike)."""
    params, pos, _ = standin.toy_system(300, 170, g, num_anm=2 if per_pose else 0,
                                        seed=seed, method=method)
    gen = "v1" if pose_bits else "v2"
    params = kernel_params(params, gen)
    fn = make_kernel_energy_fn(params, "cpu", torch.float32, kernel=gen)
    rng = np.random.RandomState(seed)
    n_c = -(-g // POSE_BLOCK)
    t = (np.repeat(rng.uniform(-45, 45, (n_c, 3)), POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3)))
    k = 2 if per_pose else 0
    cols = [torch.as_tensor(x, dtype=torch.float32)
            for x in (t, pos[:, 3:7], pos[:, 7:7 + k], pos[:, 7 + k:7 + 2 * k])]
    args, kwargs = fn.kernel_args(torch_params(params, "cpu", torch.float32), *cols)
    assert args[0].shape[0] == (g if per_pose else 1)
    assert _ulps_from_cutoffs(args[0], args[1]) > 8
    iface = torch.as_tensor((rng.rand(*args[-1].shape) < 0.5).astype(np.int32))
    return args[:-1] + (iface,), kwargs.get("near_chunks")


# jit: one compile of each interpreted kernel a shape, not eager tracing.
_PALLAS_V1 = jax.jit(functools.partial(pe.elec_vdw_pairs_pallas, interpret=True,
                                       r_tile=R_TILE, l_tile=L_TILE))
_PALLAS_V2 = jax.jit(functools.partial(pe.elec_vdw_pairs_pallas_v2, interpret=True,
                                       r_tile=R_TILE, l_tile=L_TILE, need_iface=True,
                                       p_block=POSE_BLOCK))


def _pallas(args, near, pose_bits):
    """JAX's kernel on the same inputs in interpret mode: (raw, ifr, ifl)."""
    arrays = [jnp.asarray(x.numpy()) for x in args]
    if pose_bits:   # the v1 kernel takes the receptor per pose
        g = args[1].shape[0]
        arrays[0] = jnp.broadcast_to(arrays[0], (g,) + arrays[0].shape[1:])
        return [np.asarray(x) for x in _PALLAS_V1(*arrays)]
    near = None if near is None else jnp.asarray(near.numpy())
    return [np.asarray(x) for x in _PALLAS_V2(*arrays, near_chunks=near)]


@pytest.mark.parametrize("method", ["dna", "pydock"])
@pytest.mark.parametrize("per_pose", [False, True])
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_moved_reciprocal_matches_pallas(method, per_pose, kernel):
    pose_bits = kernel == "K5"
    args, near = _inputs(method, per_pose, pose_bits)
    plain = (k5.elec_vdw_pairs_v1_plain(*args, r_tile=R_TILE, l_tile=L_TILE) if pose_bits
             else ev.elec_vdw_pairs_plain(*args, r_tile=R_TILE, l_tile=L_TILE, near_chunks=near))
    exact = _model(args, near, None, pose_bits)
    for ours, theirs in zip(exact, plain):   # the model is the plain versions' arithmetic
        assert torch.equal(ours, theirs)
    if not pose_bits:
        act = args[-2]
        assert 0 < int((near * act).sum()) < int(act.sum())   # some chunk-tiles are far
    ref = _pallas(args, near, pose_bits)
    assert np.abs(ref[0]).max() > 1.0
    for shift in ("+", "-", "seeded"):
        raw, ifr, ifl = _model(args, near, shift, pose_bits)
        assert not torch.equal(raw, exact[0]), shift   # the move shows in the sums
        np.testing.assert_allclose(raw.numpy(), ref[0], **TOL, err_msg=shift)
        np.testing.assert_array_equal(ifr.numpy(), ref[1])
        np.testing.assert_array_equal(ifl.numpy(), ref[2])
    assert ifr.sum() > 0 and ifl.sum() > 0


@pytest.mark.parametrize("per_pose", [False, True])
def test_moved_reciprocal_at_cutoff_edges(per_pose):
    """On ``standin.cutoff_edge_case`` (pairs within an ulp of the
    interface, vdw and elec cutoffs) the moved reciprocal changes no mask
    or flag: the model's sums stay within 5e-5 of the JAX kernels' and are
    exactly zero where theirs are."""
    case = standin.cutoff_edge_case(per_pose=per_pose)
    for kernel, (args, kwargs) in (("K3", case.k3), ("K5", case.k5)):
        pose_bits = kernel == "K5"
        ref = _pallas(args, None, pose_bits)
        raw, ifr, ifl = _model(args, None, "seeded", pose_bits)
        np.testing.assert_allclose(raw.numpy(), ref[0], **TOL)
        np.testing.assert_array_equal(raw.numpy() == 0, ref[0] == 0)
        np.testing.assert_array_equal(ifr.numpy(), ref[1])
        np.testing.assert_array_equal(ifl.numpy(), ref[2])


@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_coincident_pair_stays_nan(kernel):
    """d2 == 0: the reciprocal is +inf, moved or not, so vdw goes NaN
    through inf - inf in the model as in the JAX kernel; at 0.01 A both
    clamp to the same finite sum."""
    pose_bits = kernel == "K5"
    for lig_x, nan in ((1e-2, False), (0.0, True)):
        def vec(v):
            return torch.full((1,), v, dtype=torch.float32)

        ones = torch.ones((1, 1, 1), dtype=torch.int32)
        args = (torch.zeros((1, 1, 3)), torch.tensor([[[lig_x], [0.0], [0.0]]]),
                vec(0.5), vec(0.5), vec(0.2), vec(0.2), vec(1.5), vec(1.5), ones, ones)
        raw = _model(args, None, "+", pose_bits)[0]
        ref = _pallas(args, None, pose_bits)[0]
        if nan:
            assert torch.isnan(raw).all() and np.isnan(ref).all()
        else:
            np.testing.assert_allclose(raw.numpy(), ref, **TOL)
            assert torch.isfinite(raw).all()
