"""M-step solver: Gauss-Newton with LM damping over SE(3), planar.

Port of `semicp/register/gauss_newton.py`. The JAX `while_loop` (exit
when `step <= step_eps` or after `max_iters` passes) becomes a fixed
loop of `max_iters` passes in which every state variable is frozen by a
mask once the loop would have exited. The result is identical and the
loop never waits on the device: nothing here reads a value back to the
host or copies one from it (a blocking host copy would drain the
queue). The 6x6 solve is `torch.linalg.solve_ex` in full f32 (TF32 is
off package-wide; `solve_ex` does not sync to check for singularity,
and a singular system gives non-finite steps that freeze the loop, as
the JAX version's `step > step_eps` test does on NaN).
"""

from __future__ import annotations

import torch

from semicp_torch.config import GNConfig
from semicp_torch.geom.se3 import se3_exp
from semicp_torch.register.residuals import normal_equations_collapsed


def apply_T_planar(T, z):
    """Apply (4,4) T to planar points z = (zx, zy, zz)."""
    zx, zy, zz = z
    px = T[0, 0] * zx + T[0, 1] * zy + T[0, 2] * zz + T[0, 3]
    py = T[1, 0] * zx + T[1, 1] * zy + T[1, 2] * zz + T[1, 3]
    pz = T[2, 0] * zx + T[2, 1] * zy + T[2, 2] * zz + T[2, 3]
    return px, py, pz


def gn_solve(T0, src_planes, a6, b3, c, cfg: GNConfig):
    """Minimize sum_i c_i - 2 b_i.p_i + p_i.A_i p_i over T, p_i = T z_i.

    Returns (T, final_cost, last_step_norm, H (6,6) at the final
    iterate), all tensors on T0's device.
    """
    dev, dt = T0.device, T0.dtype
    T = T0
    lam = torch.full((), cfg.lm_lambda0, dtype=dt, device=dev)
    cost = torch.full((), -1.0, dtype=dt, device=dev)
    step = torch.full((), float("inf"), dtype=dt, device=dev)
    H = torch.zeros((6, 6), dtype=dt, device=dev)
    for _ in range(cfg.max_iters):
        active = step > cfg.step_eps
        p = apply_T_planar(T, src_planes)
        H_i, g, cost_i = normal_equations_collapsed(a6, b3, c, p)
        damped = H_i + lam * torch.diag(torch.diagonal(H_i))
        delta = torch.linalg.solve_ex(damped, -g)[0]
        T_new = se3_exp(delta) @ T
        # LM schedule: grow lambda when the frozen cost increased since
        # the previous iterate, shrink otherwise
        worse = (cost >= 0.0) & (cost_i > cost)
        lam_new = torch.where(worse, lam * cfg.lm_up,
                              torch.clamp(lam * cfg.lm_down, min=cfg.lm_lambda0))
        T = torch.where(active, T_new, T)
        lam = torch.where(active, lam_new, lam)
        cost = torch.where(active, cost_i, cost)
        H = torch.where(active, H_i, H)
        step = torch.where(active, torch.linalg.vector_norm(delta), step)
    return T, cost, step, H
