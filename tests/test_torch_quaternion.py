"""Torch quaternion ops against the reference's NumPy source, at f64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lightdock_tpu.constants import LINEAR_THRESHOLD  # noqa: E402
from lightdock_tpu.ops import quaternion as ref  # noqa: E402
from lightdock_tpu_torch.ops import quaternion as qt  # noqa: E402


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
