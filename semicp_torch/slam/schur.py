"""Bundle adjustment of keyframe poses and map landmarks by Schur complement.

Port of `semicp/slam/schur.py`. Keyframe poses T_i (the same on every
rank) and map landmarks p_l (sharded over the mesh's ranks, dist/mesh.py)
with observations z_il = T_i^-1 p_l + noise:

  residual r = T_i^-1 (p_l) - z_il
  J_pose   = -R_i^T [I | -hat(p_l)]      (3x6, left-multiplied update)
  J_lm     =  R_i^T                       (3x3)

The landmark block of the normal system is block-diagonal (3x3 a
landmark), so it is eliminated in closed form:

  S   = Hpp - sum_l W_l Hll_l^-1 W_l^T,    W_l = Hpl[:, l]
  g_s = g_p - sum_l W_l Hll_l^-1 g_l

Each rank assembles its landmarks' share of S and g_s; S, g_s and the cost
are all-reduced over the group and every rank solves the same reduced
pose system; the landmarks' back-substitution stays on their rank. The
blocks are assembled with `index_add_` of each observation's blocks (Hpp,
g_p, Hll, g_l, and W_l at (landmark, pose)), as the port's pose graph is,
where the JAX package multiplies one-hot matrices. Pose 0 is fixed by
elimination (its rows and columns zeroed, a unit diagonal), the damping
is Marquardt-scaled, and a step is taken only if the all-reduced cost
falls. Every solve is full f32 (TF32 is off package-wide) with
`torch.linalg.solve_ex` and `inv_ex`, and an iteration never waits on
the device.
"""

from __future__ import annotations

import torch

from semicp_torch.geom.se3 import se3_exp, so3_hat


def _linearize(poses, lms, obs_pose, obs_lm, obs_z):
    """Residuals (O,3) and Jacobian blocks (O,3,6), (O,3,3) of the local
    observations: pose index, LOCAL landmark index, measured local
    coordinates (O,3)."""
    T = poses[obs_pose]                                  # (O,4,4)
    Rt = T[:, :3, :3].transpose(-1, -2)                  # R^T
    p = lms[obs_lm]                                      # (O,3)
    r = torch.einsum("oab,ob->oa", Rt, p - T[:, :3, 3]) - obs_z
    Jp = torch.cat([-Rt, torch.einsum("oab,obc->oac", Rt, so3_hat(p))], -1)
    return r, Jp, Rt


def _schur_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m: int, mesh, lam):
    """One linearisation, the Schur reduction over the local landmarks
    (all-reduced over the mesh where given), the pose solve and the
    local back-substitution. Returns (delta_p (m,6), delta_l (L,3))."""
    l_shard = lms.shape[0]
    r, Jp, Jl = _linearize(poses, lms, obs_pose, obs_lm, obs_z)
    w = obs_w
    f32 = dict(dtype=torch.float32, device=lms.device)
    JpTJp = torch.einsum("o,oai,oaj->oij", w, Jp, Jp)                  # (O,6,6)
    Hpp = torch.zeros((m * m, 6, 6), **f32).index_add_(0, obs_pose * (m + 1), JpTJp)
    Hpp = Hpp.reshape(m, m, 6, 6).transpose(1, 2).reshape(6 * m, 6 * m)
    g_p = -torch.zeros((m, 6), **f32).index_add_(
        0, obs_pose, torch.einsum("o,oai,oa->oi", w, Jp, r)).reshape(6 * m)
    Hll = torch.zeros((l_shard, 3, 3), **f32).index_add_(
        0, obs_lm, torch.einsum("o,oai,oaj->oij", w, Jl, Jl))
    g_l = -torch.zeros((l_shard, 3), **f32).index_add_(
        0, obs_lm, torch.einsum("o,oai,oa->oi", w, Jl, r))
    # W[l] = Hpl's block column of landmark l, (L, 6m, 3)
    W = torch.zeros((l_shard * m, 6, 3), **f32).index_add_(
        0, obs_lm * m + obs_pose, torch.einsum("o,oai,oaj->oij", w, Jp, Jl))
    W = W.reshape(l_shard, 6 * m, 3)

    # landmark damping keeps Hll SPD (isolated or padded landmarks) and the
    # eliminated block LM-consistent with the pose block
    diag = torch.diagonal(Hll, dim1=-2, dim2=-1)
    eye3 = torch.eye(3, **f32)
    Hll_inv = torch.linalg.inv_ex(Hll + lam * torch.diag_embed(diag) + 1e-6 * eye3)[0]
    WH = torch.einsum("lia,lab->lib", W, Hll_inv)                      # (L,6m,3)
    S = Hpp - torch.einsum("lib,ljb->ij", WH, W)
    g_s = g_p - torch.einsum("lib,lb->i", WH, g_l)
    if mesh is not None:
        flat = mesh.all_reduce(torch.cat([S.reshape(-1), g_s]))
        S, g_s = flat[:36 * m * m].reshape(6 * m, 6 * m), flat[36 * m * m:]

    # gauge by elimination: pose 0's rows and columns zeroed, a unit diagonal
    free = torch.arange(6 * m, device=lms.device) >= 6
    keep = free[:, None] & free[None, :]
    S = torch.where(keep, S, torch.zeros_like(S))
    g_s = torch.where(free, g_s, torch.zeros_like(g_s))
    dS = torch.diagonal(S)
    damp = torch.where(free & (dS > 0.0), lam * dS + 1e-6, torch.ones_like(dS))
    S = S + torch.diag(damp)
    delta_p = torch.linalg.solve_ex(S, g_s[:, None])[0][:, 0]
    delta_p = torch.where(free, delta_p, torch.zeros_like(delta_p))

    # back-substitute the local landmarks: dl = Hll^-1 (g_l - W^T dp)
    Wtd = torch.einsum("lia,i->la", W, delta_p)
    delta_l = torch.einsum("lab,lb->la", Hll_inv, g_l - Wtd)
    return delta_p.reshape(m, 6), delta_l


def _local_cost(poses, lms, obs_pose, obs_lm, obs_z, obs_w):
    r, _, _ = _linearize(poses, lms, obs_pose, obs_lm, obs_z)
    return torch.sum(obs_w * torch.sum(r * r, -1))


def ba_step_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m: int, mesh, lam):
    """One damped GN-Schur step, taken only if the total cost falls (both
    costs all-reduced in one collective, so every rank agrees). Returns
    (poses, lms, lam)."""
    dp, dl = _schur_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m, mesh, lam)
    new_poses = se3_exp(dp) @ poses
    new_lms = lms + dl
    c = torch.stack([_local_cost(poses, lms, obs_pose, obs_lm, obs_z, obs_w),
                     _local_cost(new_poses, new_lms, obs_pose, obs_lm, obs_z, obs_w)])
    if mesh is not None:
        c = mesh.all_reduce(c)
    ok = torch.isfinite(c[1]) & (c[1] < c[0])
    poses = torch.where(ok, new_poses, poses)
    lms = torch.where(ok, new_lms, lms)
    lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 8.0), 1e-6, 1e4)
    return poses, lms, lam


def _ba_loop(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m: int, mesh, iters: int):
    obs_pose, obs_lm = obs_pose.to(torch.int64), obs_lm.to(torch.int64)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=lms.device)
    for _ in range(iters):
        poses, lms, lam = ba_step_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m, mesh,
                                        lam)
    return poses, lms


def make_ba_solver(mesh, m: int, iters: int = 5):
    """Return solve(poses, lms, obs_pose, obs_lm, obs_z, obs_w) -> (poses,
    lms) over the mesh: poses (m,4,4) the same on every rank; this rank's
    landmarks (L_r,3) and the observations of them, their landmark
    indices LOCAL to the shard, padding rows with obs_w = 0. All tensors
    on the mesh's device."""

    def solve(poses, lms, obs_pose, obs_lm, obs_z, obs_w):
        return _ba_loop(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m, mesh, iters)

    return solve


def ba_solve_single(poses, lms, obs_pose, obs_lm, obs_z, obs_w, iters: int = 5):
    """The same solve on one device, every landmark local (the reference
    the mesh solve is held to)."""
    return _ba_loop(poses, lms, obs_pose, obs_lm, obs_z, obs_w, poses.shape[0], None, iters)
