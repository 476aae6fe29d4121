"""The port's NumPy tiling copies and torch cull ops equal the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _toy_system  # noqa: E402
from lightdock_tpu.engine import energy_pallas as ep  # noqa: E402
from lightdock_tpu.engine.energy_batch import ensure_dfire_types  # noqa: E402
from lightdock_tpu.ops import pallas_energy as pe  # noqa: E402
from lightdock_tpu.ops import quaternion as jqt  # noqa: E402
from lightdock_tpu_torch.engine.params import from_reference  # noqa: E402
from lightdock_tpu_torch.ops import cull, tiling  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("tile", [32, (32, 8), (128, 32), 64])
def test_rcb_order_matches(tile):
    coords = np.random.RandomState(7).uniform(-50, 50, (333, 3))
    np.testing.assert_array_equal(tiling.rcb_order(coords, tile),
                                  pe.rcb_order(coords, tile))


@pytest.mark.parametrize("tile", [8, 32, 128])
def test_tile_boxes_matches(tile):
    coords = np.random.RandomState(1).uniform(-20, 20, (221, 3))
    for a, b in zip(tiling.tile_boxes(coords, tile), pe.tile_boxes(coords, tile)):
        np.testing.assert_array_equal(a, b)


def test_small_helpers_match():
    nmodes = np.random.RandomState(2).standard_normal((4, 50, 3))
    np.testing.assert_array_equal(tiling.anm_mode_bounds(nmodes),
                                  pe.anm_mode_bounds(nmodes))
    np.testing.assert_array_equal(tiling.anm_mode_bounds(np.zeros((0, 5, 3))),
                                  pe.anm_mode_bounds(np.zeros((0, 5, 3))))
    params, _, _ = _toy_system(40, 20, 3)
    thr = tuple(float(x) for x in params.dfire_thresholds)
    for th in (thr, thr[:8], thr + (300.0,)):
        assert tiling.dfire_live_channels(th) == pe.dfire_live_channels(th)
        assert tiling.dfire_far_split(th) == pe.dfire_far_split(th)
    for nr, nl in ((1615, 221), (300, 170), (8000, 8000)):
        assert (tiling.cull_subsizes(nr, nl, 32, 128)
                == ep.cull_subsizes(nr, nl, 32, 128))
    coords = np.random.RandomState(3).uniform(-9, 9, (70, 3))
    c, h = pe.tile_boxes(coords, 8)
    for a, b in zip(tiling.pad_box_groups(c, h, 3, 4),
                    ep._pad_box_groups(c, h, 3, 4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tiling.rec_box_geometry(coords, 32, 8),
                    ep.rec_box_geometry(coords, 32, 8)):
        np.testing.assert_array_equal(a, b)


def test_spatial_sort_params_matches():
    params, _, _ = _toy_system(300, 170, 5, seed=2)
    params = ensure_dfire_types(params)
    ours = tiling.spatial_sort_params(from_reference(params), r_tile=32,
                                      l_tile=128)
    ref = ep.spatial_sort_params(params, order="rcb", r_tile=32, l_tile=128)
    for name in ("rec_coords", "lig_coords", "rec_res_onehot", "lig_res_onehot",
                 "rec_membrane_mask", "atom_types_rec", "atom_types_lig",
                 "dfire_dq", "dfire_rec_half", "dfire_lig_onehot", "rec_nmodes",
                 "lig_nmodes"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name),
                                      err_msg=name)


def test_cull_ops_match():
    """Box cull bits, ANM slack and Morton keys equal the reference's."""
    rng = np.random.RandomState(5)
    rec = rng.uniform(-20, 20, (200, 3))
    lig = rng.uniform(-8, 8, (90, 3))
    rc, rh = tiling.pad_box_groups(*tiling.tile_boxes(rec, 8), 7, 4)
    lc, lh = tiling.pad_box_groups(*tiling.tile_boxes(lig, 32), 1, 4)
    g = 23
    t = rng.uniform(-25, 25, (g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    slack = rng.uniform(0, 1, g)
    cuts = (15.0, 2.45, 8.0)
    rot = jqt.rotation_matrix(q, np)
    ref = pe.cull_mask_boxes(*(jnp.asarray(x) for x in (rc, rh, lc, lh, t, rot,
                                                        slack, slack)), cuts)
    ours = cull.cull_mask_boxes(*(torch.as_tensor(x) for x in (rc, rh, lc, lh, t,
                                                              rot, slack, slack)),
                                cuts)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < sum(int(a.sum()) for a in ours) < sum(a.numel() for a in ours)

    coefs = rng.uniform(-2, 2, (9, 4))
    bounds = pe.anm_mode_bounds(rng.standard_normal((4, 50, 3)))
    np.testing.assert_allclose(
        cull.pose_slack(torch.as_tensor(coefs), bounds).numpy(),
        np.asarray(pe.pose_slack(jnp.asarray(coefs), bounds)), rtol=1e-15)

    t32 = rng.uniform(-30, 30, (57, 3)).astype(np.float32)
    np.testing.assert_array_equal(cull.morton_key(torch.as_tensor(t32)).numpy(),
                                  np.asarray(ep._morton_key(jnp.asarray(t32))))
