"""The sharded kernel path on the card: receptor atoms over 2 ranks, each
launching K1, or K3 with a per-pose receptor, on its slice, against the
single-GPU kernel energy.  The ranks share card 0 through gloo, and where
there are two cards each rank takes its own through NCCL.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports neither JAX nor
the JAX package, so it runs where they are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py
"""

import json

import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu_torch import standin  # noqa: E402
from lightdock_tpu_torch.engine.runner import make_energy  # noqa: E402
from lightdock_tpu_torch.parallel import sharded  # noqa: E402
from lightdock_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from lightdock_tpu_torch.parallel.multihost import (  # noqa: E402
    maybe_initialize_distributed, spawn_local)

pytestmark = pytest.mark.cuda

G = 48
SYSTEMS = {"dfire": dict(n_rec=600, n_lig=150), "dna": dict(n_rec=500, n_lig=200, num_anm=3)}


def _system(method):
    kw = dict(SYSTEMS[method])
    return standin.toy_system(kw.pop("n_rec"), kw.pop("n_lig"), G, method=method, seed=3, **kw)


def _poses(pos, k, device):
    cols = (pos[:, :3], pos[:, 3:7], pos[:, 7:7 + k], pos[:, 7 + k:7 + 2 * k])
    return [torch.as_tensor(c, dtype=torch.float32, device=device) for c in cols]


def ranks(rank, out, backend):
    """Each rank: its slice's energy of the G poses, and its kernel's
    launches, for both methods.  gloo ranks share card 0."""
    maybe_initialize_distributed(backend, timeout=120)
    mesh = make_mesh(n_swarm=1, n_atoms=2,
                     device=f"cuda:{rank if backend == 'nccl' else 0}")
    res = {}
    for method in SYSTEMS:
        params, pos, k = _system(method)
        p_loc, energy_fn = sharded.make_kernel_atom_sharded_fns(params, mesh)
        before = energy_fn.kernel.launches
        scores = energy_fn(p_loc, *_poses(pos, k, mesh.device))
        torch.cuda.synchronize()
        res[method] = dict(scores=scores.cpu().tolist(), kernel=energy_fn.kernel.__name__,
                           launches=energy_fn.kernel.launches - before)
    (out / f"rank{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module", params=["gloo", "nccl"])
def results(request, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if request.param == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL ranks need a card each: two cards")
    out = tmp_path_factory.mktemp(f"sharded_{request.param}")
    spawn_local(ranks, 2, out, request.param)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("method,kernel", [("dfire", "dfire_pairs"),
                                           ("dna", "elec_vdw_pairs")])
def test_sharded_kernel_energy_on_the_card(results, method, kernel):
    """Each rank launches its slice's kernel once; the combined scores
    equal the single-GPU kernel energy at 5e-5 and are the same on both
    ranks, bit for bit."""
    params, pos, k = _system(method)
    tp, energy_fn = make_energy(params, "kernel", "cuda", torch.float32)
    want = energy_fn(tp, *_poses(pos, k, "cuda")).cpu()
    for r in results:
        assert r[method]["kernel"] == kernel and r[method]["launches"] == 1
        got = torch.tensor(r[method]["scores"], dtype=torch.float32)
        assert torch.allclose(got, want, rtol=5e-5, atol=5e-5), float((got - want).abs().max())
    assert results[0][method]["scores"] == results[1][method]["scores"]
