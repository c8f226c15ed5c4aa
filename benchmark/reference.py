"""Plain reference of semantic EM-ICP (plain torch, any dtype).

A straightforward implementation of the registration semantics the system
states, written from the method and not from the system's code; it imports
nothing of the system. It serves the comparison that decides `correct`:
in float64 it judges a pose the system produced, and in bfloat16 it is the
control, put in the system's place.

The semantics (Parkison et al., BMVC 2018; the system's defaults):
* covariances: per point, the same-class neighbours within a radius r
  (d^2 < r^2, the point itself included) give a covariance C; it is
  replaced by I - (1 - eps) n n^T with n its smallest eigenvector, or by I
  where fewer than 3 neighbours exist. r is 1.3 times the median, over 256
  points strided through the cloud in class-major Morton order (labels,
  then 10-bit Morton codes of the coordinates quantised by a 2 m cell),
  of the distance to the k-th same-class neighbour (k = 20, self apart);
* E-step at pose T: every source point z, moved to p = T z with covariance
  R C_z R^T, takes in every class k its exact nearest target point x_k of
  that class, kept where |x_k - p| <= gate; Sigma_k = C_k + R C_z R^T; the
  weights are a softmax over the kept classes of
  log N(x_k - p; 0, Sigma_k) + log prior_k, prior_k = alpha where k is
  the point's own label and (1 - alpha) / (K - 1) otherwise;
* M-step: T minimises sum_i sum_k w_ik (x_k - T z_i)^T Sigma_k^-1 (x_k - T z_i)
  with the weights and Sigma frozen, solved here by Gauss-Newton to
  convergence over left updates T <- exp(delta) T;
* EM alternates the two until the pose moves by less than `tol`.
A pose the system reports is judged by running this EM from it: at a
fixed point of the same semantics it does not move.

`store`, where given, is a lower precision in which every per-point array
is kept between the steps (the scan, its covariances, the moved points
and their covariances, the E-step's planes), with the arithmetic in
`dtype`: bfloat16 storage of float32 work is the control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from benchmark import geom

LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class Params:
    classes: int = 20
    gate: float = 2.0
    alpha: float = 0.85
    cov_k: int = 20
    cov_eps: float = 1e-3
    radius_samples: int = 256
    radius_scale: float = 1.3
    morton_cell: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


def _q(x, store):
    """x kept in `store` (rounded there and back), or as it is."""
    return x if store is None else x.to(store).to(x.dtype)


@dataclass
class Prepared:
    store: object          # the storage dtype of the per-point arrays, or None
    xyz: torch.Tensor      # (M, 3)
    label: torch.Tensor    # (M,) int64
    cov: torch.Tensor      # (M, 3, 3) regularised covariances
    radius: float
    by_class: dict         # k -> (xyz (M_k, 3), cov (M_k, 3, 3))


def _spread3(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def class_morton_order(xyz32: torch.Tensor, label: torch.Tensor, cell: float):
    """Permutation by (label, Morton code), stable; xyz32 (M, 3) float32."""
    lo = xyz32.amin(0)
    q = torch.clamp(((xyz32 - lo) / cell).to(torch.int32), 0, 1023).to(torch.int64)
    code = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
    return torch.sort((label.to(torch.int64) << 31) | code, stable=True).indices


def _zorder(P, cell: float):
    """Rows of P in Morton order of `cell`-sized cells (blocks of the order
    cover compact regions)."""
    q = torch.clamp(torch.floor((P - P.amin(0)) / cell).to(torch.int64), 0, 1023)
    return torch.argsort(_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2))


def _blocks(P, order, X, reach: float, rows: int):
    """(query rows, candidate rows of X) for blocks of `rows` queries in the
    order `order`: the candidates are X's points inside the block's box
    grown by `reach`, which holds every point within `reach` of any query
    of the block."""
    for s in range(0, len(P), rows):
        qi = order[s:s + rows]
        Q = P[qi]
        lo, hi = Q.amin(0) - reach, Q.amax(0) + reach
        yield qi, torch.nonzero(((X >= lo) & (X <= hi)).all(1))[:, 0]


def neighbourhood_radius(xyz, label, xyz32, p: Params) -> torch.Tensor:
    order = class_morton_order(xyz32, label, p.morton_cell)
    m = len(xyz)
    s = min(p.radius_samples, m)
    idx = order[(torch.arange(s, device=xyz.device) * m) // s]
    q, ql = xyz[idx], label[idx]
    d2 = ((q[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(ql[:, None] == label[None, :], d2, torch.full_like(d2, float("inf")))
    kk = min(p.cov_k + 1, m)
    kth = torch.topk(d2, kk, dim=1, largest=False).values[:, -1].to(torch.float64)
    kth = kth[torch.isfinite(kth)]
    if len(kth) == 0:
        return torch.ones((), dtype=torch.float64, device=xyz.device) * p.radius_scale
    s_k = torch.sort(kth).values
    med = 0.5 * (s_k[(len(s_k) - 1) // 2] + s_k[len(s_k) // 2])
    return p.radius_scale * torch.sqrt(med)


def smallest_eigvec(C):
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3):
    the eigenvalue by Smith's trigonometric formula, the vector as the
    largest cross product of two rows of C - lambda I (+z where C is
    isotropic)."""
    a, b, c = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    d, e, f = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    q = (a + b + c) / 3.0
    p1 = d * d + e * e + f * f
    p = torch.sqrt(torch.clamp(((a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2.0 * p1) / 6.0,
                               min=1e-30))
    B = (C - q[..., None, None] * torch.eye(3, dtype=C.dtype, device=C.device)) / p[..., None, None]
    r = torch.clamp(torch.linalg.det(B) / 2.0, -1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.arccos(r) / 3.0 + 2.0 * math.pi / 3.0)
    M = C - lam[..., None, None] * torch.eye(3, dtype=C.dtype, device=C.device)
    cands = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                         torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                         torch.linalg.cross(M[..., 1, :], M[..., 2, :])], -2)
    norms = (cands * cands).sum(-1)
    best = torch.gather(cands, -2, norms.argmax(-1)[..., None, None].expand(
        *norms.shape[:-1], 1, 3))[..., 0, :]
    n = torch.sqrt(norms.amax(-1))
    z = torch.zeros_like(best)
    z[..., 2] = 1.0
    return torch.where((n > 0)[..., None], best / torch.clamp(n, min=1e-300)[..., None], z)


def covariances(xyz, label, radius, p: Params) -> torch.Tensor:
    """(M, 3, 3) regularised covariances, from same-class neighbours within
    radius, centred on each query point."""
    dt, dev = xyz.dtype, xyz.device
    r = float(radius)
    eye = torch.eye(3, dtype=dt, device=dev)
    cov = eye.repeat(len(xyz), 1, 1)
    for k in torch.unique(label).tolist():
        sel = torch.nonzero(label == k)[:, 0]
        X = xyz[sel]
        out = eye.repeat(len(X), 1, 1)
        for qi, ci in _blocks(X, _zorder(X, r), X, r, 2048):
            D = X[ci][None, :, :] - X[qi][:, None, :]                 # (b, c, 3)
            w = ((D * D).sum(-1) < r * r).to(dt)
            n = w.sum(1)
            m1 = torch.einsum("bj,bja->ba", w, D) / n[:, None]
            m2 = torch.einsum("bja,bjc->bac", w[..., None] * D, D) / n[:, None, None]
            nvec = smallest_eigvec(m2 - m1[:, :, None] * m1[:, None, :])
            reg = eye - (1.0 - p.cov_eps) * nvec[:, :, None] * nvec[:, None, :]
            out[qi] = torch.where((n >= 3)[:, None, None], reg, eye)
        cov[sel] = out
    return cov


def prepare(pts: np.ndarray, labels: np.ndarray, p: Params, dtype=torch.float64,
            device="cpu", store=None) -> Prepared:
    """A scan's points, labels and covariances, as the reference uses them."""
    xyz32 = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(device)
    label = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    xyz = _q(xyz32.to(dtype), store)
    r = neighbourhood_radius(xyz, label, xyz32, p)
    cov = _q(covariances(xyz, label, r.to(dtype), p), store)
    by_class = {k: (xyz[label == k], cov[label == k]) for k in torch.unique(label).tolist()}
    return Prepared(store=store, xyz=xyz, label=label, cov=cov, radius=float(r),
                    by_class=by_class)


def _inv_det3(S):
    """Closed-form inverse and determinant of symmetric (..., 3, 3)."""
    a, b, c = S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]
    d, e, f = S[..., 0, 1], S[..., 0, 2], S[..., 1, 2]
    A = b * c - f * f
    B = e * f - d * c
    C = d * f - e * b
    det = a * A + d * B + e * C
    inv = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([B, a * c - e * e, d * e - a * f], -1),
                       torch.stack([C, d * e - a * f, a * b - d * d], -1)], -2)
    return inv / det[..., None, None], det


def nearest(P, order, X, gate: float, rows: int = 8192):
    """For every row of P, its exact nearest row of X where one lies within
    `gate`: (index, d^2), with d^2 = inf where none does (`order`: P's rows
    in Morton order, `_zorder`)."""
    idx = torch.zeros((len(P),), dtype=torch.int64, device=P.device)
    d2 = torch.full((len(P),), float("inf"), dtype=P.dtype, device=P.device)
    for qi, ci in _blocks(P, order, X, gate, rows):
        if len(ci) == 0:
            continue
        Q, C = P[qi], X[ci]
        if P.dtype == torch.float64:
            D = (Q * Q).sum(1)[:, None] + (C * C).sum(1)[None, :] - 2.0 * (Q @ C.T)
        else:
            D = sum((Q[:, None, a] - C[None, :, a]) ** 2 for a in range(3))
        j = torch.argmin(D, dim=1)
        w = C[j] - Q
        idx[qi] = ci[j]
        d2[qi] = (w * w).sum(1)
    return idx, d2


def estep(src: Prepared, tgt: Prepared, T, p: Params):
    """Per-point planes A (Q,3,3), b (Q,3), c (Q,) at pose T, and the
    correspondence count: the sum of the weights, which is the number of
    source points with a neighbour of some class within the gate."""
    dt = src.xyz.dtype
    R, t = T[:3, :3], T[:3, 3]
    moved = _q(src.xyz @ R.T + t, src.store)
    rc = _q(R @ src.cov @ R.T, src.store)
    hit, miss = math.log(p.alpha), math.log((1.0 - p.alpha) / max(p.classes - 1, 1))
    logl, sinv, xs = [], [], []
    order = _zorder(moved, p.gate)
    for k, (X, C) in tgt.by_class.items():
        idx, d2 = nearest(moved, order, X, p.gate)
        x = X[idx]
        S_inv, det = _inv_det3(C[idx] + rc)
        d = x - moved
        maha = torch.einsum("qa,qab,qb->q", d, S_inv, d)
        ll = -0.5 * (maha + torch.log(det) + 3.0 * LOG_2PI)
        ll = ll + torch.where(src.label == k, hit, miss).to(dt)
        keep = d2 <= p.gate * p.gate
        logl.append(torch.where(keep, ll, torch.full_like(ll, -float("inf"))))
        sinv.append(S_inv)
        xs.append(x)
    L = torch.stack(logl)                                           # (K', Q)
    mx = L.amax(0)
    found = torch.isfinite(mx)
    e = torch.exp(L - torch.where(found, mx, torch.zeros_like(mx)))
    w = torch.where(found, e / e.sum(0).clamp_min(1e-30), torch.zeros_like(e))
    A = torch.zeros((len(moved), 3, 3), dtype=dt, device=moved.device)
    b = torch.zeros((len(moved), 3), dtype=dt, device=moved.device)
    c = torch.zeros((len(moved),), dtype=dt, device=moved.device)
    for wk, Si, x in zip(w, sinv, xs):
        Sx = (Si @ x[:, :, None])[..., 0]
        A = A + wk[:, None, None] * Si
        b = b + wk[:, None] * Sx
        c = c + wk * (x * Sx).sum(1)
    return _q(A, src.store), _q(b, src.store), _q(c, src.store), float(w.sum())


def mstep(T, z, A, b, iters: int = 20, tol: float = 1e-12):
    """argmin_T sum_i c_i - 2 b_i.p_i + p_i.A_i p_i, p_i = T z_i, by
    Gauss-Newton from T (J_i = [I | -hat(p_i)] for the left update).
    Returns (T, H): H = sum_i J_i^T A_i J_i (6, 6), translation first, at
    the last Gauss-Newton pass's pose."""
    dt = z.dtype
    solve_dt = torch.float64 if dt == torch.float64 else torch.float32
    H = torch.zeros((6, 6), dtype=dt, device=z.device)
    for _ in range(iters):
        p = z @ T[:3, :3].T + T[:3, 3]
        J = torch.cat([torch.eye(3, dtype=dt, device=z.device).expand(len(p), 3, 3),
                       -geom.hat(p)], -1)                           # (Q, 3, 6)
        AJ = A @ J
        H = torch.einsum("qai,qaj->ij", J, AJ)
        g = torch.einsum("qai,qa->i", J, b - (A @ p[:, :, None])[..., 0])
        delta, info = torch.linalg.solve_ex(H.to(solve_dt), g.to(solve_dt))
        if int(info) != 0 or not bool(torch.isfinite(delta).all()):
            break       # no correspondences constrain the pose: it stays
        T = geom.exp(delta.to(dt)) @ T
        if float(torch.linalg.vector_norm(delta)) < tol:
            break
    return T, H


class EMResult(NamedTuple):
    T: np.ndarray          # (4, 4) float64, where the EM stopped
    passes: int
    step: float            # the last pass's pose step
    n_first: float         # correspondence count at T0 (the first E-step)
    n_last: float          # at the last E-step's pose, as an align reports it
    H: np.ndarray          # (6, 6) float64 Gauss-Newton Hessian of the last pass


def em(src: Prepared, tgt: Prepared, T0, p: Params, max_passes: int = 8,
       tol: float = 2e-6) -> EMResult:
    """The reference's EM from T0, until a pose step under `tol` or
    `max_passes`."""
    T = torch.as_tensor(np.asarray(T0), dtype=src.xyz.dtype, device=src.xyz.device)
    step = float("inf")
    passes = 0
    counts = []
    for passes in range(1, max_passes + 1):
        A, b, _, n = estep(src, tgt, T, p)
        counts.append(n)
        T_new, H = mstep(T, src.xyz, A, b)
        step = geom.gap(T_new.double(), T.double())
        T = T_new
        if step < tol:
            break
    return EMResult(T.double().cpu().numpy(), passes, step, counts[0], counts[-1],
                    H.double().cpu().numpy())
