"""The box cull's tile bits (``ops.cull.cull_tile_bits``) on the CPU: its
plain version against the chain the kernel energy path ran before it,
``cull_mask_boxes`` over the sub-boxes, the OR to kernel tiles, the moved
gate and the OR over pose chunks, bit for bit; and the energy path's
kernel arguments against that chain.  The kernel itself
(``csrc/cull_bits.cu``) is held to the plain version on the card by
``tests/test_torch_cuda.py``.

    python -m pytest tests/test_torch_cull_bits.py -q
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch import constants as C  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import torch_params  # noqa: E402
from lightdock_tpu_torch.ops import cull, tiling  # noqa: E402
from lightdock_tpu_torch.ops import quaternion as qt  # noqa: E402
from lightdock_tpu_torch.ops.dfire_pairs import POSE_BLOCK  # noqa: E402
from lightdock_tpu_torch.standin import toy_system  # noqa: E402
from lightdock_tpu_torch.utils import metrics  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def chain(rc, rh, lc, lh, t, rot, rs, ls, cuts, rg, lg, moved, chunked):
    """The cull as the energy path ran it before ``cull_tile_bits``."""
    g = t.shape[0]
    n_r, n_l = rc.shape[0] // rg, lc.shape[0] // lg
    fine = cull.cull_mask_boxes(rc, rh, lc, lh, t, rot, rs, ls, cuts)
    bits = [a.reshape(n_r, rg, n_l, lg, g).amax(dim=(1, 3)) for a in fine]
    if moved is not None:
        bits = [b * moved.to(torch.int32)[None, None, :] for b in bits]
    gp = -(-g // POSE_BLOCK) * POSE_BLOCK

    def chunk(a):
        a = torch.nn.functional.pad(a, (0, gp - g))
        return a.reshape(n_r, n_l, gp // POSE_BLOCK, POSE_BLOCK).amax(dim=-1)

    return [chunk(b) if c else b for b, c in zip(bits, chunked)]


def boxes(rng, n_rec, n_lig, fallback, dtype):
    """Receptor and ligand cull boxes as the energy path builds them, the
    padding groups included; (rc, rh, lc, lh, rg, lg)."""
    r_tile, l_tile = tiling.R_TILE, tiling.L_TILE
    rec = rng.uniform(-20, 20, (n_rec, 3))
    rec = rec[tiling.rcb_order(rec, (r_tile, tiling.R_SUB))]
    lig = rng.uniform(-12, 12, (n_lig, 3))
    lig = lig[tiling.rcb_order(lig, (l_tile, tiling.L_SUB))]
    r_sub, l_sub = (r_tile, l_tile) if fallback else (tiling.R_SUB, tiling.L_SUB)
    n_l = -(-n_lig // l_tile)
    rc, rh = tiling.rec_box_geometry(rec, r_tile, r_sub)
    lc, lh = tiling.pad_box_groups(*tiling.tile_boxes(lig, l_sub), n_l, l_tile // l_sub)
    out = [torch.as_tensor(x, dtype=dtype) for x in (rc, rh, lc, lh)]
    return (*out, r_tile // r_sub, l_tile // l_sub)


def poses(rng, g, dtype):
    """Poses clustered by chunk, so that the chunks' ORs cull too."""
    n_c = -(-g // POSE_BLOCK)
    t = (np.repeat(rng.uniform(-45, 45, (n_c, 3)), POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3)))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t, q = torch.as_tensor(t, dtype=dtype), torch.as_tensor(q, dtype=dtype)
    return t, qt.rotation_matrix(q)


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("g", [37, 64])
@pytest.mark.parametrize("kernel", ["v1", "v2"])
@pytest.mark.parametrize("n_cuts", [2, 3])
@pytest.mark.parametrize("slack", ["rigid", "rec", "lig", "both"])
def test_plain_equals_the_chain(slack, n_cuts, kernel, g, fallback, moved):
    """Rigid and ANM slack, 2 and 3 cutoffs, per-pose (v1) and chunked
    (v2) output, G a multiple of 16 or not, padded boxes (the sub-boxes of
    203 receptor atoms fill 7 tiles with 2 padding boxes, those of 150
    ligand atoms 2 tiles with 3), the fallback to tile boxes, with and
    without the moved gate: bit for bit the chain's."""
    rng = np.random.RandomState(zlib.crc32(repr((slack, n_cuts, kernel, g, fallback,
                                                     moved)).encode()))
    dtype = torch.float32
    rc, rh, lc, lh, rg, lg = boxes(rng, 203, 150, fallback, dtype)
    assert fallback or (int(torch.isinf(rh[:, 0]).sum()), int(torch.isinf(lh[:, 0]).sum())) == (2, 3)
    t, rot = poses(rng, g, dtype)
    zeros = torch.zeros(g, dtype=dtype)
    rs = torch.as_tensor(rng.uniform(0, 3, g), dtype=dtype) if slack in ("rec", "both") else zeros
    ls = torch.as_tensor(rng.uniform(0, 3, g), dtype=dtype) if slack in ("lig", "both") else zeros
    cuts = (15.0, (C.INTERFACE_CUTOFF + 1.0) / 2.0, 8.0)[:n_cuts]
    chunked = tuple(kernel == "v2" and k != 1 for k in range(n_cuts))
    gate = torch.as_tensor(rng.rand(g) < 0.7) if moved else None
    want = chain(rc, rh, lc, lh, t, rot, rs, ls, cuts, rg, lg, gate, chunked)
    s = {"rigid": None, "rec": rs, "lig": ls, "both": rs + ls}[slack]
    got, counts = cull.cull_tile_bits(rc, rh, lc, lh, t, rot, s, cuts, (rg, lg), chunked,
                                      gate, count=True)
    assert counts is None                        # only the kernel counts
    n_r, n_l = rc.shape[0] // rg, lc.shape[0] // lg
    for a, b, c in zip(got, want, chunked):
        assert a.dtype == torch.int32
        assert tuple(a.shape) == (n_r, n_l, -(-g // POSE_BLOCK) if c else g)
        assert torch.equal(a, b)
    assert 0 < int(got[0].sum()) < got[0].numel()    # some tile-poses culled, some kept


def test_plain_at_float64_equals_the_chain():
    """A float64 state (the CPU runners' default) takes the plain version,
    equal to the chain at float64."""
    rng = np.random.RandomState(11)
    rc, rh, lc, lh, rg, lg = boxes(rng, 203, 150, False, torch.float64)
    t, rot = poses(rng, 45, torch.float64)
    slack = torch.as_tensor(rng.uniform(0, 2, 45))
    cuts = (15.0, 2.45, 8.0)
    chunked = (True, False, True)
    got, counts = cull.cull_tile_bits(rc, rh, lc, lh, t, rot, slack, cuts, (rg, lg), chunked)
    want = chain(rc, rh, lc, lh, t, rot, slack, torch.zeros(45, dtype=torch.float64),
                 cuts, rg, lg, None, chunked)
    assert counts is None and all(torch.equal(a, b) for a, b in zip(got, want))


def test_box_bound_is_the_masks_threshold():
    """``cull_mask_boxes`` is ``box_d2_lower_bound`` against each cutoff^2,
    inf on every padding box."""
    rng = np.random.RandomState(3)
    rc, rh, lc, lh, _, _ = boxes(rng, 203, 150, False, torch.float32)
    t, rot = poses(rng, 20, torch.float32)
    s = torch.zeros(20)
    d2 = cull.box_d2_lower_bound(rc, rh, lc, lh, t, rot, s, s)
    assert tuple(d2.shape) == (20, rc.shape[0], lc.shape[0])
    pad_r, pad_l = torch.isinf(rh).any(dim=1), torch.isinf(lh).any(dim=1)
    assert bool(torch.isinf(d2[:, pad_r]).all()) and bool(torch.isinf(d2[:, :, pad_l]).all())
    for c, m in zip((15.0, 6.0), cull.cull_mask_boxes(rc, rh, lc, lh, t, rot, s, s, (15.0, 6.0))):
        assert torch.equal(m, (d2 <= c * c).permute(1, 2, 0).to(torch.int32))


def test_cut2_up_is_the_float32_at_or_above():
    cuts = (15.0, (C.INTERFACE_CUTOFF + 1.0) / 2.0, C.VDW_DIST_CUTOFF, C.ELEC_DIST_CUTOFF,
            float(np.sqrt(56.25)), 0.1)
    for c, f in zip(cuts, cull.cut2_up(cuts)):
        c2 = float(c) ** 2
        assert np.float32(f) == f and f >= c2
        assert float(np.nextafter(np.float32(f), np.float32(0))) < c2


def kernel_case(method, kernel, num_anm):
    params, pos, _ = toy_system(150, 140, 40, num_anm=num_anm, seed=4, method=method,
                                dfire_mode="steps" if kernel == "v1" else "auto")
    return kernel_params(params, kernel), pos


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("method,kernel,num_anm", [("dfire", "v2", 0), ("dfire", "v2", 2),
                                                   ("dna", "v2", 2), ("dfire", "v1", 0),
                                                   ("dna", "v1", 2)])
def test_kernel_args_bits_equal_the_chain(method, kernel, num_anm, moved):
    """The energy path's kernel arguments carry the chain's bits: the
    method's cutoffs, the slack of each side's ANM, v1's per-pose bits and
    v2's chunks, the gate."""
    params, pos = kernel_case(method, kernel, num_anm)
    dtype = torch.float32
    fn = make_kernel_energy_fn(params, "cpu", dtype, kernel=kernel)
    tp = torch_params(params, "cpu", dtype)
    rng = np.random.RandomState(9)
    g = pos.shape[0]
    t, _ = poses(rng, g, dtype)
    q = torch.as_tensor(pos[:, 3:7], dtype=dtype)
    a_rec = torch.as_tensor(pos[:, 7:7 + num_anm], dtype=dtype)
    a_lig = torch.as_tensor(pos[:, 7 + num_anm:], dtype=dtype)
    gate = torch.as_tensor(rng.rand(g) < 0.6) if moved else None
    args, kwargs = fn.kernel_args(tp, t, q, a_rec, a_lig, gate)

    r_sub, l_sub = tiling.cull_subsizes(params.rec_coords.shape[0],
                                        params.lig_coords.shape[0], tiling.R_TILE, tiling.L_TILE)
    rg, lg = tiling.R_TILE // r_sub, tiling.L_TILE // l_sub
    n_l = -(-params.lig_coords.shape[0] // tiling.L_TILE)
    rc, rh = tiling.rec_box_geometry(params.rec_coords, tiling.R_TILE, r_sub)
    lc, lh = tiling.pad_box_groups(*tiling.tile_boxes(params.lig_coords, l_sub), n_l, lg)
    rc, rh, lc, lh = (torch.as_tensor(np.asarray(x), dtype=dtype) for x in (rc, rh, lc, lh))
    zeros = torch.zeros(g, dtype=dtype)
    slack = [cull.pose_slack(a, tiling.anm_mode_bounds(m)) if num_anm else zeros
             for a, m in ((a_rec, params.rec_nmodes), (a_lig, params.lig_nmodes))]
    iface = (C.INTERFACE_CUTOFF + 1.0) / 2.0 if method == "dfire" else C.INTERFACE_CUTOFF
    energy = 15.0 if method == "dfire" else C.ELEC_DIST_CUTOFF
    if kernel == "v1":
        cuts, got = (energy, iface), list(args[-2:])
    else:
        near = (float(np.sqrt(args[2].thresholds[args[2].split])) if method == "dfire"
                else C.VDW_DIST_CUTOFF)
        cuts, got = (energy, iface, near), [args[-2], args[-1], kwargs["near_chunks"]]
    chunked = tuple(kernel == "v2" and k != 1 for k in range(len(cuts)))
    want = chain(rc, rh, lc, lh, t, qt.rotation_matrix(q), *slack, cuts, rg, lg, gate, chunked)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < sum(int(b.sum()) for b in got) < sum(b.numel() for b in got)


def test_cpu_records_no_cull_counters():
    """Under a recorder the CPU path runs the plain version, which counts
    nothing: the counters are the kernel's, on the card."""
    params, pos = kernel_case("dfire", "v2", 0)
    fn = make_kernel_energy_fn(params, "cpu", torch.float32)
    tp = torch_params(params, "cpu", torch.float32)
    x = torch.as_tensor(pos, dtype=torch.float32)
    none = torch.zeros((x.shape[0], 0))
    with metrics.record() as rec:
        fn.kernel_args(tp, x[:, :3], x[:, 3:7], none, none)
        assert rec.take()[1] == {}
