"""Plain reference of the pose-graph optimisation (plain torch).

The method the system states (keyframe SLAM's back end, Levenberg-Marquardt
over SE(3) with a Huber kernel), written from that statement and importing
nothing of the system:
* an edge (i, j) measures Z_ij ~ T_i^-1 T_j; its residual is
  r = log(Z^-1 T_i^-1 T_j), its information info * W (`edge_weight`:
  info the align's Hessian's mean diagonal, W that Hessian scaled to
  trace 6 plus 1e-3 I), the informations scaled to mean 1;
* the cost is sum_e info_e rho(sqrt(r^T W r)), rho Huber's with threshold
  `huber`;
* the Gauss-Newton system takes first-order Jacobians, dr/ddelta_j =
  Ad(T_j^-1) = -dr/ddelta_i, each edge weighted by info times Huber's
  weight at its whitened norm; pose 0 is held fixed;
* Levenberg-Marquardt steps T <- exp(delta) T, damped by lam diag(H), are
  taken only where the cost falls.
Run from the poses the system returned, it moves them to its own fixed
point; the distance they move judges them. `store`, where given, keeps
the poses in that precision between iterations (the control).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import geom


def _adjoint(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    A = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    A[..., :3, :3] = R
    A[..., :3, 3:] = geom.hat(t) @ R
    A[..., 3:, 3:] = R
    return A


def _residuals(T, e):
    Ti, Tj = T[e["i"]], T[e["j"]]
    r = geom.log(geom.inverse(e["z"]) @ geom.inverse(Ti) @ Tj)
    return r, _adjoint(geom.inverse(Tj))


def _cost(T, e, huber):
    r, _ = _residuals(T, e)
    n = torch.sqrt(torch.clamp(torch.einsum("ea,eab,eb->e", r, e["W"], r), min=0.0))
    rho = torch.where(n <= huber, 0.5 * n * n, huber * (n - 0.5 * huber))
    return float((e["info"] * rho).sum()), r, n


def optimise(poses: np.ndarray, edges: dict, huber: float, dtype=torch.float64, store=None,
             iters: int = 200, tol: float = 1e-12) -> np.ndarray:
    """The reference's LM from `poses` (m, 4, 4); edges: i, j (E,), z (E, 4, 4),
    info (E,), W (E, 6, 6), as numpy arrays. Returns the poses it ends at."""
    def keep(x):
        return x if store is None else x.to(store).to(dtype)

    T = keep(torch.as_tensor(np.asarray(poses), dtype=dtype))
    e = {"i": torch.as_tensor(edges["i"], dtype=torch.int64),
         "j": torch.as_tensor(edges["j"], dtype=torch.int64),
         "z": keep(torch.as_tensor(np.asarray(edges["z"]), dtype=dtype)),
         "W": torch.as_tensor(np.asarray(edges["W"]), dtype=dtype)}
    info = torch.as_tensor(np.asarray(edges["info"]), dtype=dtype)
    e["info"] = info / torch.clamp(info.mean(), min=1e-30)
    m = len(T)
    lam = 1e-4
    cost, r, n = _cost(T, e, huber)
    for _ in range(iters):
        _, Jj = _residuals(T, e)
        w = e["info"] * torch.where(n <= huber, torch.ones_like(n), huber / torch.clamp(n, 1e-12))
        We = w[:, None, None] * e["W"]
        JtWJ = Jj.transpose(1, 2) @ We @ Jj
        JtWr = (Jj.transpose(1, 2) @ We @ r[:, :, None])[..., 0]
        H = torch.zeros((m, m, 6, 6), dtype=dtype)
        g = torch.zeros((m, 6), dtype=dtype)
        for a, b, blk in ((e["i"], e["i"], JtWJ), (e["j"], e["j"], JtWJ),
                          (e["i"], e["j"], -JtWJ), (e["j"], e["i"], -JtWJ.transpose(1, 2))):
            H.index_put_((a, b), blk, accumulate=True)
        g.index_put_((e["j"],), JtWr, accumulate=True)
        g.index_put_((e["i"],), -JtWr, accumulate=True)
        H = H.permute(0, 2, 1, 3).reshape(6 * m, 6 * m)[6:, 6:]     # pose 0 held fixed
        g = g.reshape(-1)[6:]
        Hd = H + torch.diag(lam * torch.diagonal(H) + 1e-12)
        delta = torch.zeros((m, 6), dtype=dtype)
        delta[1:] = torch.linalg.solve(Hd, -g).reshape(m - 1, 6)
        T_new = keep(geom.exp(delta) @ T)
        c_new, r_new, n_new = _cost(T_new, e, huber)
        if c_new < cost:
            T, cost, r, n = T_new, c_new, r_new, n_new
            lam = max(lam * 0.3, 1e-12)
            if float(delta.abs().max()) < tol:
                break
        else:
            lam *= 8.0
            if lam > 1e8:
                break
    return T.to(torch.float64).numpy()


def edge_weight(H) -> tuple[float, np.ndarray]:
    """An align's edge weight from its 6x6 Gauss-Newton Hessian H: the
    scalar information, H's mean diagonal, and W, H made symmetric and
    scaled to trace 6 with 1e-3 I added (no direction left unweighted)."""
    H = np.asarray(H, np.float64)
    H = 0.5 * (H + H.T)
    tr = max(float(np.trace(H)) / 6.0, 1e-30)
    return float(np.mean(np.diagonal(H))), H / tr + 1e-3 * np.eye(6)


def graph_edges(graph) -> tuple[np.ndarray, dict]:
    """The active poses and edges of a pose graph (an object with poses,
    n_poses, edge_i, edge_j, edge_z, edge_info, edge_W, n_edges)."""
    m, n = graph.n_poses, graph.n_edges
    return (np.asarray(graph.poses[:m], np.float64),
            {"i": np.asarray(graph.edge_i[:n]), "j": np.asarray(graph.edge_j[:n]),
             "z": np.asarray(graph.edge_z[:n], np.float64),
             "info": np.asarray(graph.edge_info[:n], np.float64),
             "W": np.asarray(graph.edge_W[:n], np.float64)})


def pose_set_gap(A: np.ndarray, B: np.ndarray) -> float:
    """The largest ||log(A_i B_i^-1)|| over the poses."""
    a = torch.as_tensor(A, dtype=torch.float64)
    b = torch.as_tensor(B, dtype=torch.float64)
    return float(torch.linalg.vector_norm(geom.log(a @ geom.inverse(b)), dim=-1).max())
