"""Trajectory evaluation: ATE (Umeyama-aligned RMSE) and RPE.

Port of `semicp/eval/ate.py`, unchanged: pure numpy in float64, so
evaluation inherits no device precision and both packages score a
trajectory the same way.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, ref: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est -> ref.

    est, ref: (N, 3) matched positions. Returns (R, t, s) minimizing
    ||ref - (s R est + t)||^2 (Umeyama 1991; Horn's closed form).
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    mu_e, mu_r = est.mean(0), ref.mean(0)
    e, r = est - mu_e, ref - mu_r
    cov = r.T @ e / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-300))
    else:
        s = 1.0
    t = mu_r - s * R @ mu_e
    return R, t, s


def ate_rmse(est_poses: np.ndarray, ref_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over (N,4,4) pose arrays."""
    p_e = np.asarray(est_poses, np.float64)[:, :3, 3]
    p_r = np.asarray(ref_poses, np.float64)[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(p_e, p_r)
        p_e = (s * (R @ p_e.T)).T + t
    d = p_e - p_r
    return float(np.sqrt((d * d).sum(-1).mean()))


def rpe(est_poses: np.ndarray, ref_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gap `delta`.

    Returns (trans_rmse [m], rot_rmse [rad]).
    """
    E = np.asarray(est_poses, np.float64)
    G = np.asarray(ref_poses, np.float64)
    terrs, rerrs = [], []
    for i in range(len(E) - delta):
        de = np.linalg.inv(E[i]) @ E[i + delta]
        dg = np.linalg.inv(G[i]) @ G[i + delta]
        err = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return float(np.sqrt((terrs**2).mean())), float(np.sqrt((rerrs**2).mean()))
