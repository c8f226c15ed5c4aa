"""semicp_torch.eval against semicp.eval on the same trajectories.

Tolerance: both are float64 numpy with the same operations, so results
agree to 1e-12 relative (they are equal to the bit in practice). The
pair judges (`semicp_torch.eval.pairs`): pose_errors equals the JAX
tests' helper to the bit, em_step (float64) the align's f32 se3_log norm
within 1e-5 relative plus 2e-7 (f32 rounding of T T_prev^-1), and
trip_parity is held to hand-built trajectories.
"""

import numpy as np
import pytest
import torch

from semicp.eval import ate_rmse as j_ate
from semicp.eval import rpe as j_rpe
from semicp.eval import umeyama_alignment as j_umeyama
from semicp_torch.data import make_trajectory
from semicp_torch.eval import ate_rmse, em_step, pose_errors, rpe, trip_parity, umeyama_alignment
from semicp_torch.geom.se3 import se3_exp, se3_log
from test_register import pose_errors as j_pose_errors


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


def test_pose_errors_and_em_step(trajectories):
    """pose_errors as tests/test_register.py computes it; em_step as the
    align measures it, the norm of the f32 se3_log of T T_prev^-1."""
    est, gt = trajectories
    for a, b in zip(est[:5], gt[:5]):
        assert pose_errors(a, b) == tuple(float(x) for x in j_pose_errors(a, b))
    rng = np.random.default_rng(2)
    for scale in (1e-5, 1e-4, 1e-2, 0.3):
        d = (rng.normal(size=6) * scale).astype(np.float32)
        T_prev = est[3]
        T = se3_exp(torch.from_numpy(d)).double().numpy() @ T_prev
        D = (T @ np.linalg.inv(T_prev)).astype(np.float32)
        ref = float(torch.linalg.vector_norm(se3_log(torch.from_numpy(D))))
        assert abs(em_step(T, T_prev) - ref) <= 1e-5 * ref + 2e-7, (scale, ref)


def chain(steps):
    """Poses after each pass from the identity: pass k moves x by steps[k]."""
    out = [np.eye(4)]
    for s in steps:
        T = out[-1].copy()
        T[0, 3] += s
        out.append(T)
    return out


def runs(traj):
    """run(max_iters) -> (T, iterations) of a path with this trajectory."""
    n = len(traj) - 1
    return lambda mi: (traj[n if mi is None else min(mi, n)], n if mi is None else min(mi, n))


@pytest.mark.parametrize("case", ["equal", "one_apart", "two_apart", "apart_at_common",
                                  "equal_far", "two_apart_at_threshold", "two_apart_tail"])
def test_trip_parity_rule(case):
    """Equal trip counts: T within tol. Counts one apart: T within tol at the
    smaller count and the final T within tol plus the extra pass's step;
    the stop margins are |em_step / trans_eps - 1| at that pass. Counts two
    apart hold only where each pass the longer path went on from was a
    tail step, em_step at most 2 trans_eps (a dist SLAM pair on the H100:
    1.0005, 1.08, stop); extra passes that move more, or paths that part
    before the smaller count, break the rule."""
    eps = 1e-4
    a = [0.3, 0.05, 0.002, 1.02e-4]
    b = {"equal": a[:3] + [1.02e-4 + 2e-6], "one_apart": a[:3] + [0.99e-4],
         "two_apart": a[:2], "apart_at_common": [0.3, 0.05, 0.0025],
         "equal_far": a[:3] + [3e-4], "two_apart_at_threshold": a[:3] + [0.94e-4],
         "two_apart_tail": a[:3] + [0.94e-4]}[case]
    if case == "one_apart":
        a = a + [0.5e-4]                 # a runs a fifth pass, b stops at its fourth
    if case == "two_apart_at_threshold":
        a = a[:3] + [1.0005e-4, 1.08e-4, 0.81e-4]  # a goes on by a hair, then its tail
    if case == "two_apart_tail":
        a = a[:3] + [1.4e-4, 1.3e-4, 0.9e-4]       # two tail steps under 2 trans_eps
    r = trip_parity(runs(chain(a)), runs(chain(b)), eps)
    assert r["ok"] == (case in ("equal", "one_apart", "two_apart_at_threshold",
                                "two_apart_tail")), r
    if case == "one_apart":
        assert r["iterations"] == (5, 4) and r["common_pass"] == 4
        assert abs(r["extra_pass_step"] - 0.5e-4) < 1e-12
        assert np.allclose(r["stop_margins"], (0.02, 0.01), atol=1e-6)
        assert np.allclose(r["go_on_margins"], (0.02, 0.5), atol=1e-6)
    if case == "two_apart_at_threshold":
        assert r["iterations"] == (6, 4)
        assert np.allclose(r["go_on_margins"], (0.0005, 0.08, 0.19), atol=1e-6)
