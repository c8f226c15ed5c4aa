"""M-step solver: Gauss-Newton with LM damping over SE(3), planar.

Port of `semicp/register/gauss_newton.py`. `gn_solve` takes the plain
version on CPU tensors and launches kernel G1 (csrc/gn_solve.cu) on CUDA
ones: one launch a GN pass, the 28 sums, the 6x6 solve, se3_exp and the
LM schedule all on the device, the pose and the loop state kept there.

`gn_solve_plain` is the JAX `while_loop` (exit when `step <= step_eps` or
after `max_iters` passes) as a fixed loop of `max_iters` passes in which
every state variable is frozen by a mask once the loop would have exited.
The result is identical and the loop never waits on the device. The 6x6
solve is `torch.linalg.solve_ex` in full f32 (TF32 is off package-wide;
`solve_ex` does not sync to check for singularity, and a singular system
gives non-finite steps that freeze the loop, as the JAX version's
`step > step_eps` test does on NaN). G1 keeps these semantics: each pass
whose state's step is not above `step_eps` returns at once.
"""

from __future__ import annotations

import torch

from semicp_torch import kernels
from semicp_torch.config import GNConfig
from semicp_torch.geom.se3 import se3_exp
from semicp_torch.register.residuals import normal_equations_collapsed

GN_BLOCK = 256        # threads of a G1 block (csrc/gn_solve.cu kBlock)
GN_BLOCKS_PER_SM = 2  # blocks of a pass on each SM (its __launch_bounds__)
GN_STATE = 64         # floats of G1's state: T, H, cost, step, lambda, passes


def apply_T_planar(T, z):
    """Apply (4,4) T to planar points z = (zx, zy, zz)."""
    zx, zy, zz = z
    px = T[0, 0] * zx + T[0, 1] * zy + T[0, 2] * zz + T[0, 3]
    py = T[1, 0] * zx + T[1, 1] * zy + T[1, 2] * zz + T[1, 3]
    pz = T[2, 0] * zx + T[2, 1] * zy + T[2, 2] * zz + T[2, 3]
    return px, py, pz


def gn_solve_plain(T0, src_planes, a6, b3, c, cfg: GNConfig):
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


def gn_solve(T0, src_planes, a6, b3, c, cfg: GNConfig):
    """`gn_solve_plain`'s result: by it on CPU tensors, by G1 on CUDA.

    src_planes: the (3, N) source planes (or three (N,) planes); a6 (6, N),
    b3 (3, N), c (N,): the E-step's collapsed planes; T0 (4, 4). On CUDA
    the four results are views of one device state, with nothing read back
    to the host; the state is left in `kernels.WALKED["gn_solve"]`.
    """
    if not T0.is_cuda:
        return gn_solve_plain(T0, src_planes, a6, b3, c, cfg)
    dev = T0.device
    z = src_planes if torch.is_tensor(src_planes) else torch.stack(tuple(src_planes))
    n = z.shape[1]
    f32 = torch.float32
    z, a6, b3, c, T0 = (t.contiguous() for t in (z, a6, b3, c, T0))
    for t, name, shape in ((z, "src_planes", (3, n)), (a6, "a6", (6, n)), (b3, "b3", (3, n)),
                           (c, "c", (n,)), (T0, "T0", (4, 4))):
        kernels.check(t, name, f32, shape)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-n // GN_BLOCK), GN_BLOCKS_PER_SM * sms))
    state = torch.empty((GN_STATE,), dtype=f32, device=dev)
    partials = torch.empty((blocks, 28), dtype=f32, device=dev)
    ticket = torch.empty((1,), dtype=torch.int32, device=dev)
    kernels.launch("semicp_gn_solve", "gn_solve", dev, z.data_ptr(), a6.data_ptr(),
                   b3.data_ptr(), c.data_ptr(), T0.data_ptr(), n, blocks, cfg.max_iters,
                   cfg.lm_lambda0, cfg.lm_up, cfg.lm_down, cfg.step_eps, state.data_ptr(),
                   partials.data_ptr(), ticket.data_ptr())
    kernels.WALKED["gn_solve"] = state
    return state[:16].view(4, 4), state[52], state[53], state[16:52].view(6, 6)
