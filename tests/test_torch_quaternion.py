"""Torch quaternion ops against the reference's NumPy source, at f64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu.constants import LINEAR_THRESHOLD  # noqa: E402
from lightdock_tpu.ops import quaternion as ref  # noqa: E402
from lightdock_tpu_torch.ops import quaternion as qt  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests' tensors are small, and several test
    processes with a thread pool each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quats(n, seed):
    q = np.random.RandomState(seed).standard_normal((n, 4)) * 1.7
    return q


def test_rotation_matrix_matches():
    q = _quats(64, 0)   # unnormalised: the 1/|q|^2 factor matters
    np.testing.assert_allclose(qt.rotation_matrix(torch.as_tensor(q)).numpy(),
                               ref.rotation_matrix(q, np), rtol=0, atol=1e-12)


def test_qnormalize_matches():
    q = _quats(16, 3)
    np.testing.assert_allclose(qt.qnormalize(torch.as_tensor(q)).numpy(),
                               ref.qnormalize(q, np), rtol=0, atol=1e-12)


@pytest.mark.parametrize("t", [0.5, 0.1, 0.9])
def test_slerp_matches(t):
    """Covers the sign flip, the linear branch above LINEAR_THRESHOLD and
    the spherical branch."""
    q1 = _quats(64, 1)
    q2 = _quats(64, 2)
    q2[:8] = q1[:8] * 1.3 + 1e-4          # nearly parallel: linear branch
    q2[8:16] = -q1[8:16] + 1e-3           # antiparallel: flip + linear
    a = ref.qnormalize(q1, np)
    b = ref.qnormalize(q2, np)
    d = np.abs((a * b).sum(-1))
    assert (d > LINEAR_THRESHOLD).sum() >= 16 and (d <= LINEAR_THRESHOLD).sum() >= 32
    np.testing.assert_allclose(
        qt.slerp(torch.as_tensor(q1), torch.as_tensor(q2), t).numpy(),
        ref.slerp(q1, q2, t, np), rtol=0, atol=1e-12)


def test_rotate_matches():
    """The Hamilton product form ``q v q^-1``, |q| != 1 included, of
    single quaternions (the host scorer's) and a batch."""
    q = _quats(8, 4)
    v = np.random.RandomState(5).standard_normal((8, 30, 3)) * 20
    for a, b in zip(q, v):
        np.testing.assert_allclose(qt.rotate(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                   ref.rotate(a, b, np), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        qt.rotate(torch.as_tensor(q[:, None]), torch.as_tensor(v)).numpy(),
        ref.rotate(q[:, None], v, np), rtol=0, atol=1e-12)
