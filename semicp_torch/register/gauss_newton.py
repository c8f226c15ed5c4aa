"""M-step solver and the end of the EM pass: Gauss-Newton with LM damping
over SE(3), planar.

Port of `semicp/register/gauss_newton.py`, and of the lines of
`semicp/register/em_icp.py` that XLA fuses with it into one program: the
convergence test and the next E-step's inputs.

* `gn_solve_plain` is the JAX `while_loop` (exit when `step <= step_eps`
  or after `max_iters` passes) as a fixed loop of `max_iters` passes in
  which every state variable is frozen by a mask once the loop would have
  exited. The result is identical and the loop never waits on the device.
  The 6x6 solve is `torch.linalg.solve_ex` in full f32 (TF32 is off
  package-wide; `solve_ex` does not sync to check for singularity, and a
  singular system gives non-finite steps that freeze the loop, as the JAX
  version's `step > step_eps` test does on NaN).
* `em_tail_plain` is an EM pass after its E-step: `gn_solve_plain`, then
  `em_step = ||se3_log(T T_in^-1)||`, `n_corr = sum(wsum)` and the next
  E-step's inputs at the new pose (`move_source_plain`). It is the CPU
  path and G1's reference.
* `em_tail` takes `em_tail_plain` on CPU tensors and launches kernel G1
  (csrc/gn_solve.cu) on CUDA ones: every GN pass, the solve, se3_exp, the
  LM schedule, em_step, n_corr, moved and rc in one cooperative launch,
  the state kept on the device. `move_source` is G1 with no GN pass (the
  first E-step's inputs).

Distributed mode (`gn_solve(..., axis_name=...)` of the JAX package: the
points sharded over a mesh, H, g and the cost all-reduced in every GN
pass; dist/align_dist.py runs it):

* `gn_solve_dist_plain` is `gn_solve_plain` with the group's all-reduce
  of each pass's system; `em_tail_dist_plain` adds em_step, the
  all-reduced n_corr and the local moved and rc. They are the CPU path and
  the reference of:
* `em_tail_dist` on CUDA: `gn_solve_dist` runs max(gn.max_iters, 1) GN
  passes of G1's distributed entries, each a reduce launch (the pass's 29
  sums over this rank's points, added in block order), the all-reduce of
  that row and an update launch (the solve, se3_exp, the LM schedule and
  em_step on G1's state), with no host read; then `move_source`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from semicp_torch import kernels
from semicp_torch.config import GNConfig
from semicp_torch.geom import sym3
from semicp_torch.geom.se3 import se3_exp, se3_inverse, se3_log
from semicp_torch.register.residuals import normal_equations_collapsed

# G1's state (csrc/gn_solve.cu), GN_STATE floats: T at S_T (4,4), H at S_H
# (6,6), then cost, GN step, lambda, passes run, em_step and n_corr
GN_STATE = 64
S_T, S_H, S_COST, S_STEP, S_PASSES, S_EM_STEP, S_N_CORR = 0, 16, 52, 53, 55, 56, 57
GN_ROW = 32     # floats of a block's partial row of G1's sums

# (device index, N, stage) -> (blocks, share, smem bytes, staged, partials)
_PLANS: dict = {}


class EMTail(NamedTuple):
    T: torch.Tensor        # (4,4) pose after the M-step
    cost: torch.Tensor     # () the last GN pass's cost, at its starting pose
    step: torch.Tensor     # () the last GN step's norm
    H: torch.Tensor        # (6,6) the last GN pass's Hessian
    em_step: torch.Tensor  # () ||se3_log(T T_in^-1)||
    n_corr: torch.Tensor   # () sum of the E-step's wsum
    moved: torch.Tensor    # (3,N) the source at T
    rc: torch.Tensor       # (6,N) the source covariances rotated by T


def apply_T_planar(T, z):
    """Apply (4,4) T to planar points z = (zx, zy, zz)."""
    zx, zy, zz = z
    px = T[0, 0] * zx + T[0, 1] * zy + T[0, 2] * zz + T[0, 3]
    py = T[1, 0] * zx + T[1, 1] * zy + T[1, 2] * zz + T[1, 3]
    pz = T[2, 0] * zx + T[2, 1] * zy + T[2, 2] * zz + T[2, 3]
    return px, py, pz


def gn_solve_plain(T0, src_planes, a6, b3, c, cfg: GNConfig, reduce=None):
    """Minimize sum_i c_i - 2 b_i.p_i + p_i.A_i p_i over T, p_i = T z_i.

    `reduce(H, g, cost)`, where given, maps each pass's system over these
    points to the system over all of them (`gn_solve_dist_plain`).
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
        if reduce is not None:
            H_i, g, cost_i = reduce(H_i, g, cost_i)
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


def move_source_plain(T, z, cov6):
    """The E-step's inputs at T: the moved source (3,N) and its rotated
    covariances R C R^T (6,N)."""
    moved = torch.stack(apply_T_planar(T, tuple(z)))
    rc = sym3.pack(sym3.rotate(T[:3, :3], tuple(cov6)))
    return moved, rc


def em_tail_plain(T_in, z, cov6, a6, b3, c, wsum, cfg: GNConfig) -> EMTail:
    """An EM pass after its E-step, from the pose T_in: the M-step, the
    convergence measure, the correspondence count, and the next E-step's
    inputs at the new pose."""
    T, cost, step, H = gn_solve_plain(T_in, z, a6, b3, c, cfg)
    em_step = torch.linalg.vector_norm(se3_log(T @ se3_inverse(T_in)))
    moved, rc = move_source_plain(T, z, cov6)
    return EMTail(T, cost, step, H, em_step, torch.sum(wsum), moved, rc)


def launch_plan(dev: torch.device, n: int, stage: bool = True):
    """G1's launch plan for n points on dev, (blocks, points a block,
    dynamic shared memory bytes, staged), and its partials scratch, made
    once and kept (the kernels run in stream order, so calls share the
    scratch)."""
    key = (dev.index, n, stage)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = kernels.library().semicp_gn_plan(n, int(stage), out)
        if err != 0:
            raise RuntimeError(f"semicp_gn_plan: CUDA error {err}")
        blocks, share, smem, staged = out
        partials = torch.empty((2, blocks, GN_ROW), dtype=torch.float32, device=dev)
        plan = _PLANS[key] = (blocks, share, smem, staged, partials)
    return plan


def _check_source(T, z, cov6):
    n = z.shape[1]
    for t, name, shape in ((z, "z", (3, n)), (cov6, "cov6", (6, n)), (T, "T", (4, 4))):
        kernels.check(t, name, torch.float32, shape)
    return n


class TailOut:
    """Buffers that G1 writes, kept across calls: a state (GN_STATE,), moved
    (3,N) and rc (6,N), with the `EMTail` of views into them made once."""

    def __init__(self, state, moved, rc):
        self.state = state
        self.ptrs = (state.data_ptr(), moved.data_ptr(), rc.data_ptr())
        self.tail = EMTail(state[S_T:S_T + 16].view(4, 4), state[S_COST], state[S_STEP],
                           state[S_H:S_H + 36].view(6, 6), state[S_EM_STEP], state[S_N_CORR],
                           moved, rc)


def tail_outputs(n: int, dev, states: int = 1) -> list:
    """`states` TailOuts for n points on dev that share one moved and one rc.
    An EM loop takes two, alternating by pass, so that G1 never writes the
    pose it starts from; each E-step reads moved and rc before the next G1
    writes them."""
    f32 = torch.float32
    st = torch.empty((states, GN_STATE), dtype=f32, device=dev)
    moved = torch.empty((3, n), dtype=f32, device=dev)
    rc = torch.empty((6, n), dtype=f32, device=dev)
    return [TailOut(st[i], moved, rc) for i in range(states)]


def move_source(T, z, cov6, out: TailOut | None = None):
    """`move_source_plain`'s result: by it on CPU tensors, by G1 with no GN
    pass on CUDA, into out's moved and rc where given."""
    if not T.is_cuda:
        return move_source_plain(T, z, cov6)
    dev = T.device
    n = _check_source(T, z, cov6)
    blocks, share, _, _, _ = launch_plan(dev, n)
    out = out or tail_outputs(n, dev)[0]
    kernels.launch("semicp_gn_solve", "gn_solve", dev, z.data_ptr(), cov6.data_ptr(),
                   None, None, None, None, T.data_ptr(), n, blocks, share, 0, 0, 0, 0,
                   0.0, 0.0, 0.0, 0.0, None, None, *out.ptrs[1:])
    return out.tail.moved, out.tail.rc


def em_tail(T_in, z, cov6, a6, b3, c, wsum, cfg: GNConfig, out: TailOut | None = None,
            stage: bool = True) -> EMTail:
    """`em_tail_plain`'s result: by it on CPU tensors, by G1 on CUDA.

    z (3,N) source planes, cov6 (6,N) its covariances; a6 (6,N), b3 (3,N),
    c (N,), wsum (N,): the E-step's planes; T_in (4,4). On CUDA one kernel
    launch, whose results are views of out's buffers (`tail_outputs`; new
    ones where not given): the state (left in `kernels.WALKED["gn_solve"]`;
    element 55 counts the GN passes that ran), moved and rc. out's state
    must not hold T_in. stage=False reads the planes from L2 in every
    pass, the path G1 takes above what shared memory holds, for checking
    it at any N.
    """
    if not T_in.is_cuda:
        return em_tail_plain(T_in, z, cov6, a6, b3, c, wsum, cfg)
    dev = T_in.device
    n = _check_source(T_in, z, cov6)
    for t, name, shape in ((a6, "a6", (6, n)), (b3, "b3", (3, n)), (c, "c", (n,)),
                           (wsum, "wsum", (n,))):
        kernels.check(t, name, torch.float32, shape)
    blocks, share, smem, staged, partials = launch_plan(dev, n, stage)
    out = out or tail_outputs(n, dev)[0]
    kernels.launch("semicp_gn_solve", "gn_solve", dev, z.data_ptr(), cov6.data_ptr(),
                   a6.data_ptr(), b3.data_ptr(), c.data_ptr(), wsum.data_ptr(),
                   T_in.data_ptr(), n, blocks, share, smem, staged, 1, cfg.max_iters,
                   cfg.lm_lambda0, cfg.lm_up, cfg.lm_down, cfg.step_eps, out.ptrs[0],
                   partials.data_ptr(), *out.ptrs[1:])
    kernels.WALKED["gn_solve"] = out.state
    return out.tail


def gn_solve_dist_plain(T0, src_planes, a6, b3, c, cfg: GNConfig, mesh):
    """`gn_solve_plain` over points sharded on the mesh's ranks: each pass's
    H, g and cost all-reduced over the group (one collective a pass), so
    every rank takes the same steps to the bit."""

    def reduce(H, g, cost):
        flat = mesh.all_reduce(torch.cat([H.reshape(36), g.reshape(6), cost.reshape(1)]))
        return flat[:36].reshape(6, 6), flat[36:42], flat[42]

    return gn_solve_plain(T0, src_planes, a6, b3, c, cfg, reduce=reduce)


def em_tail_dist_plain(T_in, z, cov6, a6, b3, c, wsum, cfg: GNConfig, mesh) -> EMTail:
    """`em_tail_plain` over points sharded on the mesh's ranks: the M-step of
    `gn_solve_dist_plain`, em_step, n_corr summed over the group, and this
    rank's moved and rc."""
    T, cost, step, H = gn_solve_dist_plain(T_in, z, a6, b3, c, cfg, mesh)
    em_step = torch.linalg.vector_norm(se3_log(T @ se3_inverse(T_in)))
    n_corr = mesh.all_reduce(torch.sum(wsum).reshape(1))[0]
    moved, rc = move_source_plain(T, z, cov6)
    return EMTail(T, cost, step, H, em_step, n_corr, moved, rc)


def dist_plan(dev: torch.device, n: int):
    """The distributed reduce's launch plan for n points on dev, (blocks,
    points a block), and its scratch: the partial rows (blocks, 32) and
    the row (32,) the group all-reduces; made once and kept (launches and
    collectives run in stream order, so calls share them)."""
    key = ("dist", dev.index, n)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            err = kernels.library().semicp_gn_dist_plan(n, out)
        if err != 0:
            raise RuntimeError(f"semicp_gn_dist_plan: CUDA error {err}")
        blocks, share = out
        partials = torch.empty((blocks, GN_ROW), dtype=torch.float32, device=dev)
        row = torch.empty((GN_ROW,), dtype=torch.float32, device=dev)
        plan = _PLANS[key] = (blocks, share, partials, row)
    return plan


def gn_solve_dist(T_in, z, a6, b3, c, wsum, cfg: GNConfig, mesh, out: TailOut) -> TailOut:
    """`gn_solve_dist_plain`'s M-step by G1's distributed entries (CUDA
    tensors): max(cfg.max_iters, 1) GN passes of reduce, all-reduce and
    update into out's state, which must not hold T_in. Each pass counts
    one `gn_dist` launch. The state afterwards holds T, H, cost, step,
    the passes run, em_step and the all-reduced n_corr (`TailOut.tail`,
    whose moved and rc this leaves as they were)."""
    dev = T_in.device
    n = z.shape[1]
    for t, name, shape in ((T_in, "T_in", (4, 4)), (z, "z", (3, n)), (a6, "a6", (6, n)),
                           (b3, "b3", (3, n)), (c, "c", (n,)), (wsum, "wsum", (n,))):
        kernels.check(t, name, torch.float32, shape)
    blocks, share, partials, row = dist_plan(dev, n)
    for p in range(max(cfg.max_iters, 1)):
        first = int(p == 0)
        kernels.launch("semicp_gn_dist_reduce", None, dev, z.data_ptr(), a6.data_ptr(),
                       b3.data_ptr(), c.data_ptr(), wsum.data_ptr(), T_in.data_ptr(),
                       out.ptrs[0], n, blocks, share, first, cfg.max_iters, cfg.step_eps,
                       partials.data_ptr(), row.data_ptr())
        mesh.all_reduce(row)
        kernels.launch("semicp_gn_dist_update", "gn_dist", dev, row.data_ptr(),
                       T_in.data_ptr(), out.ptrs[0], first, cfg.max_iters, cfg.lm_lambda0,
                       cfg.lm_up, cfg.lm_down, cfg.step_eps)
    kernels.WALKED["gn_dist"] = out.state
    return out


def em_tail_dist(T_in, z, cov6, a6, b3, c, wsum, cfg: GNConfig, mesh,
                 out: TailOut | None = None) -> EMTail:
    """`em_tail_dist_plain`'s result: by it on CPU tensors; on CUDA by
    `gn_solve_dist`, then G1 with no GN pass at the new pose (this rank's
    moved and rc), all into out's buffers (`tail_outputs`; new ones where
    not given), whose state must not hold T_in."""
    if not T_in.is_cuda:
        return em_tail_dist_plain(T_in, z, cov6, a6, b3, c, wsum, cfg, mesh)
    out = out or tail_outputs(z.shape[1], T_in.device)[0]
    gn_solve_dist(T_in, z, a6, b3, c, wsum, cfg, mesh, out)
    move_source(out.tail.T, z, cov6, out)
    return out.tail
