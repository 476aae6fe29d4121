"""The hand-written CUDA DFIRE kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports no JAX, so it
runs where the JAX package is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from __graft_entry__ import _toy_system  # noqa: E402
from lightdock_tpu_torch.engine.energy_kernel import (  # noqa: E402
    kernel_params, make_kernel_energy_fn)
from lightdock_tpu_torch.engine.params import torch_params  # noqa: E402
from lightdock_tpu_torch.ops import dfire_pairs as dp  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _clustered_kernel_args(dev, g, seed=2):
    """The kernel's inputs for ``g`` poses clustered by chunk, so that some
    chunk-tiles are far: near bits come from the energy path's own box
    cull (truthful), cull and interface bits are seeded at random."""
    params, pos, _ = _toy_system(300, 170, g, seed=seed)
    params = kernel_params(params)
    fn = make_kernel_energy_fn(params, dev, torch.float32)
    tp = torch_params(params, dev, torch.float32)
    rng = np.random.RandomState(seed)
    n_c = -(-g // dp.POSE_BLOCK)
    t = (np.repeat(rng.uniform(-45, 45, (n_c, 3)), dp.POSE_BLOCK, axis=0)[:g]
         + rng.uniform(-3, 3, (g, 3)))
    args, kwargs = fn.kernel_args(
        tp, torch.as_tensor(t, dtype=torch.float32, device=dev),
        torch.as_tensor(pos[:, 3:7], dtype=torch.float32, device=dev))
    rec, lig, tables, act, iface = args
    act = torch.as_tensor((rng.rand(*act.shape) < 0.8).astype(np.int32), device=dev)
    iface = torch.as_tensor((rng.rand(*iface.shape) < 0.5).astype(np.int32), device=dev)
    return (rec, lig, tables, act, iface), kwargs


@pytest.mark.parametrize("g", [37, 200])
@pytest.mark.parametrize("with_near", [False, True])
@pytest.mark.parametrize("need_iface", [True, False])
def test_kernel_matches_plain(cuda, g, with_near, need_iface):
    args, kwargs = _clustered_kernel_args(cuda, g)
    near = kwargs["near_chunks"]
    assert 0 < int(near.sum()) < near.numel()      # some chunk-tiles are far
    kw = dict(r_tile=kwargs["r_tile"], l_tile=kwargs["l_tile"],
              need_iface=need_iface, near_chunks=near if with_near else None)
    before = dp.dfire_pairs.launches
    out = dp.dfire_pairs(*args, **kw)
    torch.cuda.synchronize()
    assert dp.dfire_pairs.launches == before + 1
    ref = dp.dfire_pairs_plain(*args, **kw)
    torch.testing.assert_close(out[0], ref[0], rtol=5e-5, atol=5e-5)
    if need_iface:
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        assert out[1].sum() > 0 and out[2].sum() > 0
    else:
        assert out[1] is None and out[2] is None
    again = dp.dfire_pairs(*args, **kw)
    assert torch.equal(again[0], out[0])          # deterministic sums


def test_energy_fn_on_card_matches_cpu(cuda):
    params, pos, _ = _toy_system(300, 170, 37, seed=4)
    params = kernel_params(params)
    pose = [pos[:, :3], pos[:, 3:], np.zeros((37, 0)), np.zeros((37, 0))]
    out = {}
    for dev in ("cpu", cuda):
        fn = make_kernel_energy_fn(params, dev, torch.float32)
        tp = torch_params(params, dev, torch.float32)
        out[str(dev)] = fn(tp, *(torch.as_tensor(x, dtype=torch.float32,
                                                 device=dev) for x in pose))
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=5e-5, atol=5e-5)
