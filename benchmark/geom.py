"""Plain SE(3) maps on (..., 4, 4) torch tensors, tangent [v, w].

Poses update left-multiplicatively, T <- exp(delta) T, as in the system
under test. Independent of it: the generator and the reference use these.
"""

from __future__ import annotations

import torch


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(theta2):
    """sin(t)/t, (1-cos t)/t^2 and (t - sin t)/t^3, with series near 0."""
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t))
    return a, b, c


def exp(delta):
    """(..., 6) tangent [v, w] -> (..., 4, 4)."""
    v, w = delta[..., :3], delta[..., 3:]
    a, b, c = _coeffs(torch.sum(w * w, -1))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    T = torch.zeros(delta.shape[:-1] + (4, 4), dtype=delta.dtype, device=delta.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def log(T):
    """(..., 4, 4) -> (..., 6) tangent [v, w]; rotation angles below pi."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.sin(torch.where(small, torch.ones_like(theta),
                                                             theta))))
    w = scale[..., None] * vee
    theta2 = torch.sum(w * w, -1)
    a, b, _ = _coeffs(theta2)
    t2 = torch.where(theta2 < 1e-8, torch.ones_like(theta2), theta2)
    d = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0, (1.0 - a / (2.0 * b)) / t2)
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + d[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], -1)


def inverse(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.zeros_like(T)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3] = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def gap(A, B) -> float:
    """||log(A B^-1)||: the distance between two poses, metres and radians
    in one norm (the system's own convergence measure)."""
    A = torch.as_tensor(A, dtype=torch.float64)
    B = torch.as_tensor(B, dtype=torch.float64)
    return float(torch.linalg.vector_norm(log(A @ inverse(B))))
