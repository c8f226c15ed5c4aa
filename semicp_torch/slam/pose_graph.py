"""Pose-graph optimization over SE(3): Levenberg-Marquardt with a Huber kernel.

Port of `semicp/slam/pose_graph.py`. The graph is a plain dataclass of
numpy arrays on the host, with fixed capacities (M_pad poses, E_pad
edges) and its counts as Python ints, so run_slam's `add_pose` and
`add_edge` never touch a device. `optimize_pose_graph` uploads the
active part of the graph once, runs the LM iterations on the device with
no host sync (accept or reject by `torch.where`), and brings the poses
back in one copy. On the CPU the iterations are an eager loop
(`lm_loop`); on the card (`lm_loop_graph`) the first runs eagerly and
the others replay it as a CUDA graph captured once a call, since an
iteration is some 470 small kernels whose host dispatch outweighs their
device time at a SLAM run's graph sizes.

Math (left-multiplicative updates T <- exp(delta) T, tangent [v, w]):
  edge (i, j) measures Z_ij ~ T_i^{-1} T_j
  residual r_e = log(Z_e^{-1} T_i^{-1} T_j)
  Jacobians (first-order, J_r ~ I for small r):
     dr/ddelta_i = -Ad(T_j^{-1}),  dr/ddelta_j = +Ad(T_j^{-1})
  Huber weight on the whitened norm caps loop-closure outliers.

The normal matrix is assembled with `index_add_` of each edge's four 6x6
blocks, O(E) an iteration, where the JAX package contracts one-hot
matrices (O(E M^2)). Geometry and the dense solve run in f32; TF32 is
off package-wide (semicp_torch/__init__.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from semicp_torch.config import SLAMConfig
from semicp_torch.geom.se3 import se3_adjoint, se3_exp, se3_inverse, se3_log
from semicp_torch.utils.metrics import span


@dataclass(frozen=True)
class PoseGraph:
    """Fixed-capacity pose graph on the host.

    poses:  (M_pad, 4, 4) float32 world-from-keyframe transforms
    n_poses: int
    edge_i, edge_j: (E_pad,) int32 endpoints (0 where unused)
    edge_z:  (E_pad, 4, 4) float32 measured relative transforms T_i^-1 T_j
    edge_info: (E_pad,) float32 scalar information SCALE (0 = unused)
    edge_W: (E_pad, 6, 6) float32 information SHAPE: the align's 6x6 GN
            Hessian normalized to trace/6 = 1 (identity for scalar edges);
            the edge's information is edge_info * edge_W
    n_edges: int
    """

    poses: np.ndarray
    n_poses: int
    edge_i: np.ndarray
    edge_j: np.ndarray
    edge_z: np.ndarray
    edge_info: np.ndarray
    edge_W: np.ndarray
    n_edges: int

    @classmethod
    def empty(cls, m_pad: int, e_pad: int) -> "PoseGraph":
        return cls(
            poses=np.tile(np.eye(4, dtype=np.float32), (m_pad, 1, 1)),
            n_poses=0,
            edge_i=np.zeros(e_pad, np.int32),
            edge_j=np.zeros(e_pad, np.int32),
            edge_z=np.tile(np.eye(4, dtype=np.float32), (e_pad, 1, 1)),
            edge_info=np.zeros(e_pad, np.float32),
            edge_W=np.tile(np.eye(6, dtype=np.float32), (e_pad, 1, 1)),
            n_edges=0,
        )

    def replace(self, **kw) -> "PoseGraph":
        return dataclasses.replace(self, **kw)


def _edge_residuals(poses, edge_i, edge_j, edge_z):
    Ti, Tj = poses[edge_i], poses[edge_j]                    # (E,4,4)
    r = se3_log(se3_inverse(edge_z) @ se3_inverse(Ti) @ Tj)  # (E,6)
    Jj = se3_adjoint(se3_inverse(Tj))                       # (E,6,6)
    return r, Jj


def _huber_weight(rnorm, delta):
    return torch.where(rnorm <= delta, 1.0, delta / torch.clamp(rnorm, min=1e-12))


def _whitened_norm(r, W):
    """sqrt(r^T W r) per edge: the norm Huber robustifies."""
    return torch.sqrt(torch.clamp(torch.einsum("ea,eab,eb->e", r, W, r), min=0.0))


def _huber_cost(info, rnorm, delta_h: float):
    rho = torch.where(rnorm <= delta_h, 0.5 * rnorm ** 2, delta_h * (rnorm - 0.5 * delta_h))
    return torch.sum(info * rho)


def _robust_cost(e: dict, poses, delta_h: float):
    """Huber-robustified total cost (the objective LM monotonically decreases)."""
    r, _ = _edge_residuals(poses, e["i"], e["j"], e["z"])
    return _huber_cost(e["info"], _whitened_norm(r, e["W"]), delta_h)


def device_graph(graph: PoseGraph, device) -> tuple:
    """The active poses (n_poses, 4, 4) and edges of `graph` on `device`,
    from one host-to-device copy: (poses, edges), edges a dict of i, j
    (int64), z, info (raw scale) and W."""
    m, e = graph.n_poses, graph.n_edges
    parts = [graph.poses[:m], graph.edge_z[:e], graph.edge_W[:e], graph.edge_info[:e],
             graph.edge_i[:e], graph.edge_j[:e]]
    sizes = [p.size for p in parts]
    # indices travel as f32, exact below 2^24
    flat = np.concatenate([np.asarray(p, np.float32).reshape(-1) for p in parts])
    dev = torch.from_numpy(flat).to(device)
    poses, z, W, info, ei, ej = torch.split(dev, sizes)
    edges = {"i": ei.to(torch.int64), "j": ej.to(torch.int64), "z": z.view(e, 4, 4),
             "info": info, "W": W.view(e, 6, 6)}
    return poses.view(m, 4, 4), edges


def normalized_info(edges: dict) -> dict:
    """Edge informations scaled to mean 1 over the active edges: their
    absolute scale comes from align Hessians and is arbitrary; only the
    relative weights matter, and the scaled system stays f32-conditioned."""
    info = edges["info"]
    mean_info = torch.sum(info) / max(info.shape[0], 1)
    return {**edges, "info": info / torch.clamp(mean_info, min=1e-30)}


def normal_equations(poses, edges: dict, huber: float):
    """The Huber-weighted normal equations (H (6m, 6m), g (6m,)) at `poses`,
    each edge's four 6x6 blocks and two gradient rows added by index_add_,
    and the robust cost there (from the same residuals). Ji = -Jj, so
    H_ii = H_jj = Jj^T W Jj = -H_ij, g_i = -Jj^T W r = -g_j."""
    m = poses.shape[0]
    r, Jj = _edge_residuals(poses, edges["i"], edges["j"], edges["z"])
    rnorm = _whitened_norm(r, edges["W"])
    w = edges["info"] * _huber_weight(rnorm, huber)                # (E,)
    We = w[:, None, None] * edges["W"]                              # (E,6,6)
    JtWJ = torch.einsum("eab,ead,edc->ebc", Jj, We, Jj)             # (E,6,6)
    JtWr = torch.einsum("eab,ead,ed->eb", Jj, We, r)                # (E,6)
    six = torch.arange(6, device=poses.device)
    ri = 6 * edges["i"][:, None] + six                              # (E,6) rows of pose i
    rj = 6 * edges["j"][:, None] + six

    def block(rows, cols):
        return (rows[:, :, None] * (6 * m) + cols[:, None, :]).reshape(-1)

    idx = torch.cat([block(ri, ri), block(rj, rj), block(ri, rj), block(rj, ri)])
    val = torch.cat([JtWJ, JtWJ, -JtWJ, -JtWJ.transpose(1, 2)]).reshape(-1)
    H = torch.zeros(36 * m * m, dtype=poses.dtype, device=poses.device)
    H = H.index_add_(0, idx, val).view(6 * m, 6 * m)
    g = torch.zeros(6 * m, dtype=poses.dtype, device=poses.device)
    g = g.index_add_(0, torch.cat([rj.reshape(-1), ri.reshape(-1)]),
                     torch.cat([JtWr, -JtWr]).reshape(-1))
    return H, g, _huber_cost(edges["info"], rnorm, huber)


def lm_step(poses, lam, edges: dict, huber: float):
    """One Levenberg-Marquardt iteration; returns (poses, lam), both on the
    device, without a host sync. Pose 0 is the gauge, fixed by
    elimination: its rows and columns are zeroed and its diagonal set to
    1. The system spans the active poses only: a padded pose of the JAX
    package's capacity is decoupled there (unit diagonal, zero gradient,
    so its delta is 0), and leaving it out changes no active delta."""
    m = poses.shape[0]
    free = torch.arange(m, device=poses.device) != 0
    fmask = free.repeat_interleave(6)
    H, g, c0 = normal_equations(poses, edges, huber)
    H = torch.where(fmask[:, None] & fmask[None, :], H, 0.0)
    g = torch.where(fmask, g, 0.0)
    # a free pose with no incident edges has diag(H) = 0: a unit diagonal
    # there (its delta stays 0 since g = 0), as in the JAX package
    dh = torch.diagonal(H)
    damp = torch.where(fmask & (dh > 0.0), lam * dh + 1e-6, 1.0)
    H.diagonal().add_(damp)
    # solve_ex: no singularity check, which would read the device
    delta = torch.linalg.solve_ex(H, -g[:, None])[0].reshape(m, 6)
    delta = torch.where(free[:, None], delta, 0.0)
    new_poses = se3_exp(delta) @ poses
    c1 = _robust_cost(edges, new_poses, huber)
    ok = torch.isfinite(c1) & (c1 < c0)
    poses = torch.where(ok, new_poses, poses)
    lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 8.0), 1e-6, 1e4)
    return poses, lam


def lm_loop(poses, lam, edges: dict, huber: float, iters: int):
    """`iters` LM iterations (`lm_step`), each dispatched from the host.
    Returns (poses, lam)."""
    for _ in range(iters):
        poses, lam = lm_step(poses, lam, edges, huber)
    return poses, lam


def lm_loop_graph(poses, lam, edges: dict, huber: float, iters: int):
    """`lm_loop` on CUDA tensors: the first iteration eagerly, on a side
    stream (it is also the capture's warm-up), then one `lm_step` captured
    there as a CUDA graph that writes its result back into its own inputs,
    and replayed iters - 1 times on the caller's stream: the eager loop's
    kernels in its order. The capture is made for this call's shapes (m
    poses, e edges; both grow from call to call) and freed with the call.
    The LU runs on cuSOLVER for the eager iteration and the capture
    (MAGMA's hybrid LU cannot be captured), so that every iteration runs
    the same kernels. Not `torch.cuda.graph`, which synchronises and
    empties the allocator's cache at each capture. Raises where the
    capture fails: nothing falls back to the eager loop."""
    if iters <= 0:
        return poses, lam
    with span("pgo.capture"):
        main = torch.cuda.current_stream(poses.device)
        side = torch.cuda.Stream(poses.device)
        graph = torch.cuda.CUDAGraph()
        saved = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                poses, lam = lm_step(poses, lam, edges, huber)
                if iters > 1:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        p, lm = lm_step(poses, lam, edges, huber)
                        poses.copy_(p)
                        lam.copy_(lm)
                    finally:
                        graph.capture_end()
            main.wait_stream(side)
        finally:
            torch.backends.cuda.preferred_linalg_library(saved)
    with span("pgo.replay"):
        for _ in range(iters - 1):
            graph.replay()
    return poses, lam


def optimize_pose_graph(graph: PoseGraph, cfg: SLAMConfig, device="cuda") -> PoseGraph:
    """Run cfg.pgo_iters Levenberg-Marquardt iterations on the graph, on
    `device` (the card unless the caller asks for the CPU; there as a
    replayed CUDA graph, `lm_loop_graph`).

    Robust by construction, as in the JAX package: pose 0 is gauge-fixed
    by elimination, not by a huge prior, so H stays well-conditioned in
    f32; damping is Marquardt-scaled, H + diag(lam * diag(H) + 1e-6); a
    step is taken only where the robust cost decreases, and a rejected
    step raises lam. Returns the graph with its poses replaced. Its spans:
    `pgo.upload` (the graph to the device), `pgo.capture` and
    `pgo.replay` (on the card: the eager first iteration and the capture,
    then the replays' enqueue) and `pgo.readback` (the poses' copy back,
    which waits for the replays).
    """
    if graph.n_poses == 0:
        return graph
    with span("pgo.upload"):
        poses, edges = device_graph(graph, device)
        edges = normalized_info(edges)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=poses.device)
    loop = lm_loop_graph if poses.is_cuda else lm_loop
    poses, _ = loop(poses, lam, edges, cfg.pgo_huber, cfg.pgo_iters)
    out = graph.poses.copy()
    with span("pgo.readback"):
        out[:graph.n_poses] = poses.cpu().numpy()
    return graph.replace(poses=out)


def graph_cost(graph: PoseGraph, device="cuda") -> float:
    """Total weighted squared residual (diagnostic), on `device`."""
    poses, edges = device_graph(graph, device)
    r, _ = _edge_residuals(poses, edges["i"], edges["j"], edges["z"])
    return float(torch.sum(edges["info"] * _whitened_norm(r, edges["W"]) ** 2))


def add_edge(graph: PoseGraph, i: int, j: int, z, info: float, H=None) -> PoseGraph:
    """Host-side edge insertion; returns a new graph.

    H: optional 6x6 information matrix (the align's GN Hessian). Its
    SCALE is folded into `info` by the caller (loop_closure.
    edge_info_from_hessian); here it is normalized to trace/6 = 1 and a
    small isotropic floor is added so a rank-deficient Hessian cannot
    zero out a residual direction entirely. Omit H for scalar edges.
    """
    e = graph.n_edges
    if e >= graph.edge_i.shape[0]:
        # fail loudly: past the capacity the edge would be lost while
        # n_edges kept counting
        raise ValueError(
            f"pose graph edge capacity exhausted ({e} edges >= e_pad "
            f"{graph.edge_i.shape[0]}); raise --max-edges")
    edge_W = graph.edge_W
    if H is not None:
        Hn = np.asarray(H, np.float64)
        Hn = 0.5 * (Hn + Hn.T)
        tr = max(float(np.trace(Hn)) / 6.0, 1e-30)
        edge_W = edge_W.copy()
        edge_W[e] = (Hn / tr + 1e-3 * np.eye(6)).astype(np.float32)
    edge_i, edge_j = graph.edge_i.copy(), graph.edge_j.copy()
    edge_z, edge_info = graph.edge_z.copy(), graph.edge_info.copy()
    edge_i[e], edge_j[e] = i, j
    edge_z[e] = np.asarray(z, np.float32)
    edge_info[e] = info
    return graph.replace(edge_i=edge_i, edge_j=edge_j, edge_z=edge_z, edge_info=edge_info,
                         edge_W=edge_W, n_edges=e + 1)


def add_pose(graph: PoseGraph, T) -> PoseGraph:
    m = graph.n_poses
    if m >= graph.poses.shape[0]:
        raise ValueError(
            f"pose graph keyframe capacity exhausted ({m} poses >= m_pad "
            f"{graph.poses.shape[0]}); raise --max-keyframes")
    poses = graph.poses.copy()
    poses[m] = np.asarray(T, np.float32)
    return graph.replace(poses=poses, n_poses=m + 1)
