"""semicp_torch.eval against semicp.eval on the same trajectories.

Tolerance: both are float64 numpy with the same operations, so results
agree to 1e-12 relative (they are equal to the bit in practice).
"""

import numpy as np
import pytest

from semicp.eval import ate_rmse as j_ate
from semicp.eval import rpe as j_rpe
from semicp.eval import umeyama_alignment as j_umeyama
from semicp_torch.data import make_trajectory
from semicp_torch.eval import ate_rmse, rpe, umeyama_alignment


@pytest.fixture(scope="module")
def trajectories():
    """A ground truth and a drifting, noisy estimate of it (N, 4, 4)."""
    rng = np.random.default_rng(5)
    gt = make_trajectory(30, step=0.8, turn=0.05, seed=5).astype(np.float64)
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(size=(30, 3)) * 0.02, axis=0)
    th = np.cumsum(rng.normal(size=30) * 2e-3)
    c, s = np.cos(th), np.sin(th)
    Rz = np.tile(np.eye(3), (30, 1, 1))
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1] = c, -s, s, c
    est[:, :3, :3] = Rz @ est[:, :3, :3]
    return est, gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches_jax(trajectories, with_scale):
    est, gt = trajectories
    pe, pr = est[:, :3, 3] * 1.1, gt[:, :3, 3]
    for a, b in zip(umeyama_alignment(pe, pr, with_scale), j_umeyama(pe, pr, with_scale)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("align", [True, False])
def test_ate_matches_jax(trajectories, align):
    est, gt = trajectories
    a, b = ate_rmse(est, gt, align=align), j_ate(est, gt, align=align)
    assert a > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_matches_jax(trajectories, delta):
    est, gt = trajectories
    np.testing.assert_allclose(rpe(est, gt, delta), j_rpe(est, gt, delta), rtol=1e-12)
