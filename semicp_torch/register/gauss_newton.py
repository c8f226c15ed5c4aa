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
points sharded over a mesh; dist/align_dist.py runs it):

* `gn_solve_dist_plain` is the JAX package's arithmetic: `gn_solve_plain`
  with the group's all-reduce of each pass's f32 H, g and cost;
  `em_tail_dist_plain` adds em_step, the all-reduced n_corr and the local
  moved and rc. They are the JAX mirror that the tests and chip_smoke.py
  hold the port to; no run path calls them.
* `em_tail_dist` (G1d on CUDA; `em_tail_dist_moments_plain` on CPU
  tensors) evaluates the same GN system more exactly. The E-step's planes
  are frozen for the M-step, and a pass's 28 sums are polynomials of
  degree <= 2 in p = T z, so 74 pose-independent sums of the points
  (`gn_moments_plain`: sums of a_k (z,1)(z,1)^T, b_j (z,1), c and wsum,
  in float64 because the cost cancels c against b.p and p.A p) fix every
  pass's system exactly. One M-step is this rank's moment row, one
  all-reduce of that row, and every GN pass from the row (each pass's
  sums in float64 at the pass's pose, rounded to f32, then G1's f32
  update: `normal_equations_from_moments`, `gn_solve_moments_plain`),
  em_step, n_corr and this rank's moved and rc. On CUDA that is 2
  launches and 1 collective, with no host read. The EM trajectories of
  the two arithmetics part at rounding, so where an em_step lies near
  em.trans_eps an align may stop a pass or two apart from one with f32
  sums (ROADMAP, expected differences; `semicp_torch.eval.pairs`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from semicp_torch import kernels
from semicp_torch.config import GNConfig
from semicp_torch.geom import sym3
from semicp_torch.geom.se3 import se3_exp, se3_inverse, se3_log
from semicp_torch.register.residuals import _assemble, normal_equations_collapsed

# G1's state (csrc/gn_solve.cu), GN_STATE floats: T at S_T (4,4), H at S_H
# (6,6), then cost, GN step, lambda, passes run, em_step and n_corr
GN_STATE = 64
S_T, S_H, S_COST, S_STEP, S_PASSES, S_EM_STEP, S_N_CORR = 0, 16, 52, 53, 55, 56, 57
GN_ROW = 32     # floats of a block's partial row of G1's sums
# G1d's moment row (`gn_moments_plain`), float64: 74 sums, then zeros
GN_MOM = 80
# the entries (m, l) of the symmetric (z,1)(z,1)^T in the row's order
_SYM4 = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3), (3, 3))
# Each of the 28 sums (residuals.py's layout) as (index, coefficient)
# terms over the moments at the pass's pose (`_pose_moments`): index
# 10 k + s is sum a_k pt_m pt_l with pt = (T z, 1) (a_k in sym3 order
# a00 a11 a22 a01 a02 a12, s over _SYM4: xx yy zz xy xz yz x y z 1);
# 60 + 4 j + m is sum b_j pt_m; 72 is sum c. E.g. sum 6, B_00 = a01 pz -
# a02 py, is F[38] - F[47]. The tail kernel reads this table, not a copy of
# it (`_term_table`).
_MOMENT_TERMS = (
    ((9, 1),), ((19, 1),), ((29, 1),), ((39, 1),), ((49, 1),), ((59, 1),),     # A
    ((38, 1), (47, -1)), ((8, -1), (46, 1)), ((7, 1), (36, -1)),              # B
    ((18, 1), (57, -1)), ((38, -1), (56, 1)), ((16, -1), (37, 1)),
    ((27, -1), (58, 1)), ((26, 1), (48, -1)), ((47, 1), (56, -1)),
    ((12, 1), (21, 1), (55, -2)),                                             # C
    ((23, -1), (32, -1), (45, 1), (54, 1)),
    ((14, -1), (35, 1), (41, -1), (53, 1)),
    ((2, 1), (20, 1), (44, -2)),
    ((5, -1), (34, 1), (43, 1), (50, -1)),
    ((1, 1), (10, 1), (33, -2)),
    ((6, -1), (37, -1), (48, -1), (63, 1)),                                   # u
    ((17, -1), (36, -1), (58, -1), (67, 1)),
    ((28, -1), (46, -1), (57, -1), (71, 1)),
    ((15, -1), (25, 1), (34, -1), (43, 1), (51, 1), (52, -1), (66, 1), (69, -1)),  # u x p
    ((4, 1), (24, -1), (35, 1), (40, -1), (42, 1), (53, -1), (62, -1), (68, 1)),
    ((3, -1), (13, 1), (30, 1), (31, -1), (45, -1), (54, 1), (61, 1), (64, -1)),
    ((0, 1), (11, 1), (22, 1), (33, 2), (44, 2), (55, 2), (60, -2), (65, -2), (70, -2),  # cost
     (72, 1)),
)

# the most terms of one of the 28 sums (csrc/gn_solve.cu kTerms)
TERM_WIDTH = 10

# (device index, N, stage) -> G1's (blocks, share, smem bytes, staged,
# partials); ("dist", device index, N) -> G1d's `dist_plan`
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


def _lm_loop(T0, system, cfg: GNConfig):
    """The JAX `while_loop` of `gn_solve` as a fixed loop of cfg.max_iters
    masked passes; `system(T)` gives a pass's (H, g, cost) at T. Returns
    (T, cost, step, H, passes run)."""
    dev, dt = T0.device, T0.dtype
    T = T0
    lam = torch.full((), cfg.lm_lambda0, dtype=dt, device=dev)
    cost = torch.full((), -1.0, dtype=dt, device=dev)
    step = torch.full((), float("inf"), dtype=dt, device=dev)
    H = torch.zeros((6, 6), dtype=dt, device=dev)
    passes = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.max_iters):
        active = step > cfg.step_eps
        H_i, g, cost_i = system(T)
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
        passes = passes + active.to(torch.int32)
    return T, cost, step, H, passes


def gn_solve_plain(T0, src_planes, a6, b3, c, cfg: GNConfig, reduce=None):
    """Minimize sum_i c_i - 2 b_i.p_i + p_i.A_i p_i over T, p_i = T z_i.

    `reduce(H, g, cost)`, where given, maps each pass's system over these
    points to the system over all of them (`gn_solve_dist_plain`).
    Returns (T, final_cost, last_step_norm, H (6,6) at the final
    iterate), all tensors on T0's device.
    """

    def system(T):
        sums = normal_equations_collapsed(a6, b3, c, apply_T_planar(T, src_planes))
        return sums if reduce is None else reduce(*sums)

    return _lm_loop(T0, system, cfg)[:4]


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


def _check_planes(n, a6, b3, c, wsum):
    for t, name, shape in ((a6, "a6", (6, n)), (b3, "b3", (3, n)), (c, "c", (n,)),
                           (wsum, "wsum", (n,))):
        kernels.check(t, name, torch.float32, shape)


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
    _check_planes(n, a6, b3, c, wsum)
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


def gn_moments_plain(z, a6, b3, c, wsum) -> torch.Tensor:
    """G1d's moment row of these points, (GN_MOM,) float64: with zt = (z, 1),
    [10 k + s] = sum a_k zt_m zt_l for a_k in sym3 order and (m, l) =
    _SYM4[s]; [60 + 4 j + m] = sum b_j zt_m; [72] = sum c; [73] = sum
    wsum; zeros after. The rows of disjoint point sets add up to the row
    of their union."""
    f64 = torch.float64
    n = z.shape[1]
    zt = torch.cat([z.to(f64), torch.ones((1, n), dtype=f64, device=z.device)])
    zz = torch.stack([zt[m] * zt[l] for m, l in _SYM4])                     # (10, n)
    row = torch.zeros(GN_MOM, dtype=f64, device=z.device)
    row[:60] = torch.einsum("kn,sn->ks", torch.stack(tuple(a6)).to(f64), zz).reshape(60)
    row[60:72] = torch.einsum("jn,mn->jm", torch.stack(tuple(b3)).to(f64), zt).reshape(12)
    row[72] = torch.sum(c.to(f64))
    row[73] = torch.sum(wsum.to(f64))
    return row


def _pose_moments(m, T) -> torch.Tensor:
    """The moments of row m at pose T, (73,) float64: zt replaced by pt =
    (T z, 1), so [10 k + s] = sum a_k pt_m pt_l, [60 + 4 j + m] = sum b_j
    pt_m and [72] = sum c. Each is a 4x4 product of T's rows with the row's
    moments, as the kernel forms them."""
    f64 = torch.float64
    Tt = torch.zeros((4, 4), dtype=f64, device=m.device)
    Tt[:3] = T[:3].to(f64)
    Tt[3, 3] = 1.0
    idx = torch.tensor(_SYM4, device=m.device)
    M = torch.zeros((6, 4, 4), dtype=f64, device=m.device)
    M[:, idx[:, 0], idx[:, 1]] = m[:60].reshape(6, 10)
    M[:, idx[:, 1], idx[:, 0]] = m[:60].reshape(6, 10)
    P = Tt @ M @ Tt.T
    return torch.cat([P[:, idx[:, 0], idx[:, 1]].reshape(60),
                      (m[60:72].reshape(3, 4) @ Tt.T).reshape(12), m[72:73]])


@functools.lru_cache(maxsize=None)
def _term_matrix(device: torch.device) -> torch.Tensor:
    """_MOMENT_TERMS as a (28, 73) float64 matrix on device, made once."""
    L = torch.zeros((28, 73), dtype=torch.float64)
    for s, terms in enumerate(_MOMENT_TERMS):
        for i, coef in terms:
            L[s, i] = coef
    return L.to(device)


@functools.lru_cache(maxsize=None)
def _term_table(device: torch.device) -> torch.Tensor:
    """_MOMENT_TERMS as the tail kernel reads it, (2, 28, TERM_WIDTH) int32
    on device, made once: [0] each sum's moment indices, -1 after its
    last; [1] their coefficients."""
    table = torch.zeros((2, 28, TERM_WIDTH), dtype=torch.int32)
    table[0] = -1
    for s, terms in enumerate(_MOMENT_TERMS):
        for j, (i, coef) in enumerate(terms):
            table[0, s, j], table[1, s, j] = i, coef
    return table.to(device)


def normal_equations_from_moments(m, T):
    """The GN system (H (6,6), g (6,), cost ()) of the points whose moment
    row is m (`gn_moments_plain`, summed over ranks), at pose T, in
    float64: `normal_equations_collapsed` at p = T z, up to rounding."""
    sums = _term_matrix(m.device) @ _pose_moments(m, T)
    return _assemble(sums[:, None])


def gn_solve_moments_plain(T0, m, cfg: GNConfig):
    """G1d's M-step on its float64 mirror: `gn_solve_plain`'s loop in T0's
    dtype whose every pass takes its system from the moment row m at the
    pass's pose (`normal_equations_from_moments`, rounded to T0's dtype),
    as the tail kernel does. Returns (T, cost, step, H, passes run)."""

    def system(T):
        return tuple(x.to(T.dtype) for x in normal_equations_from_moments(m, T))

    return _lm_loop(T0, system, cfg)


def dist_plan(dev: torch.device, n: int):
    """G1d's launch plan for n points on dev, (moments blocks, points a
    moments block, tail blocks), and its scratch: the moments kernel's
    partial rows (blocks, GN_MOM) and the row (GN_MOM,) the group
    all-reduces, float64; made once and kept (launches and collectives run
    in stream order, so calls share them)."""
    key = ("dist", dev.index, n)
    plan = _PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            err = kernels.library().semicp_gn_dist_plan(n, out)
        if err != 0:
            raise RuntimeError(f"semicp_gn_dist_plan: CUDA error {err}")
        blocks, share, tail_blocks = out
        partials = torch.empty((blocks, GN_MOM), dtype=torch.float64, device=dev)
        row = torch.empty((GN_MOM,), dtype=torch.float64, device=dev)
        plan = _PLANS[key] = (blocks, share, tail_blocks, partials, row)
    return plan


def em_tail_dist_moments_plain(T_in, z, cov6, a6, b3, c, wsum, cfg: GNConfig,
                               mesh) -> EMTail:
    """G1d's plain version, the CPU path of `em_tail_dist`: this rank's
    moment row (`gn_moments_plain`), the group's all-reduce of it (float64),
    every GN pass from the row (`gn_solve_moments_plain`), then em_step,
    n_corr (the row's wsum) and this rank's moved and rc at the new pose."""
    row = mesh.all_reduce(gn_moments_plain(z, a6, b3, c, wsum))
    T, cost, step, H, _ = gn_solve_moments_plain(T_in, row, cfg)
    em_step = torch.linalg.vector_norm(se3_log(T @ se3_inverse(T_in)))
    moved, rc = move_source_plain(T, z, cov6)
    return EMTail(T, cost, step, H, em_step, row[73].to(T.dtype), moved, rc)


def em_tail_dist(T_in, z, cov6, a6, b3, c, wsum, cfg: GNConfig, mesh,
                 out: TailOut | None = None) -> EMTail:
    """The distributed M-step and the EM pass's tail from this rank's
    planes: `em_tail_dist_moments_plain` on CPU tensors; on CUDA G1d,
    into out's buffers (`tail_outputs`; new ones where not given), whose
    state must not hold T_in: the moments kernel (this rank's moment row,
    `gn_moments_plain`), the group's all-reduce of that row, and the tail
    kernel (every GN pass from the row, then em_step, n_corr, and this
    rank's moved and rc at the new pose). One `gn_dist` launch counted a
    call; the state is left in `kernels.WALKED["gn_dist"]` (element 55
    counts the GN passes that ran) and the all-reduced row in the plan's
    `row` (`dist_plan`)."""
    if not T_in.is_cuda:
        return em_tail_dist_moments_plain(T_in, z, cov6, a6, b3, c, wsum, cfg, mesh)
    dev = T_in.device
    n = _check_source(T_in, z, cov6)
    _check_planes(n, a6, b3, c, wsum)
    blocks, share, tail_blocks, partials, row = dist_plan(dev, n)
    out = out or tail_outputs(n, dev)[0]
    kernels.launch("semicp_gn_dist_moments", None, dev, z.data_ptr(), a6.data_ptr(),
                   b3.data_ptr(), c.data_ptr(), wsum.data_ptr(), n, blocks, share,
                   partials.data_ptr(), row.data_ptr())
    mesh.all_reduce(row)
    kernels.launch("semicp_gn_dist_tail", "gn_dist", dev, row.data_ptr(),
                   _term_table(dev).data_ptr(), T_in.data_ptr(), z.data_ptr(),
                   cov6.data_ptr(), n, tail_blocks, cfg.max_iters,
                   cfg.lm_lambda0, cfg.lm_up, cfg.lm_down, cfg.step_eps, *out.ptrs)
    kernels.WALKED["gn_dist"] = out.state
    return out.tail
