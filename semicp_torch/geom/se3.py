"""SE(3) Lie group math in PyTorch, batched over leading dims, branchless.

Port of `semicp/geom/se3.py`. Poses are explicit (4,4) homogeneous
matrices updated left-multiplicatively, T <- exp(delta) @ T, with the
tangent ordered [v, w] (translation first). Small-angle paths use the
same Taylor thresholds and fallbacks as the JAX module, selected with
`torch.where` on a safe denominator, so delta == 0 is exact and nothing
syncs with the host.
"""

from __future__ import annotations

import torch

_SMALL = 1e-8


def _taylor_safe(theta2):
    """Return (theta, small_mask, safe_theta2) for branchless series selection."""
    small = theta2 < _SMALL
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.sqrt(safe2), small, safe2


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape[:-1] + (3, 3))


def so3_hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = torch.sum(w * w, -1)
    theta, small, _ = _taylor_safe(theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(theta2), theta2))
    W = so3_hat(w)
    W2 = W @ W
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def rotmat_to_quat(R):
    """(...,3,3) -> (...,4) unit quaternion (w, x, y, z), branchless Shepperd."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    pivots = torch.stack([1.0 + tr, 1.0 + 2.0 * r00 - tr,
                          1.0 + 2.0 * r11 - tr, 1.0 + 2.0 * r22 - tr], -1)
    best = torch.argmax(pivots, -1, keepdim=True)
    s = torch.sqrt(torch.clamp(torch.gather(pivots, -1, best)[..., 0], min=1e-12)) * 2.0

    q0 = torch.stack([0.25 * s, (r21 - r12) / s, (r02 - r20) / s, (r10 - r01) / s], -1)
    q1 = torch.stack([(r21 - r12) / s, 0.25 * s, (r01 + r10) / s, (r02 + r20) / s], -1)
    q2 = torch.stack([(r02 - r20) / s, (r01 + r10) / s, 0.25 * s, (r12 + r21) / s], -1)
    q3 = torch.stack([(r10 - r01) / s, (r02 + r20) / s, (r12 + r21) / s, 0.25 * s], -1)
    cands = torch.stack([q0, q1, q2, q3], -2)           # (...,4cand,4)
    q = torch.gather(cands, -2, best[..., None].expand(best.shape[:-1] + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q):
    """(...,4) (w,x,y,z) unit quaternion -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def so3_log(R):
    """(...,3,3) -> (...,3) axis-angle; robust up to theta = pi via quaternion."""
    q = rotmat_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    vn2 = torch.sum(v * v, -1)
    small = vn2 < _SMALL
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = 2.0 * torch.atan2(torch.sqrt(vn2), w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / vn)
    return v * scale[..., None]


def _left_jacobian_coeffs(theta2):
    """Coefficients (a, b) of V = I + a*W + b*W^2 for the SO(3) left Jacobian."""
    theta, small, safe2 = _taylor_safe(theta2)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (safe2 * theta))
    return a, b


def _homogeneous(R, t):
    top = torch.cat([R, t[..., None]], -1)
    # filled in on the device: a host tensor would be a blocking copy
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def se3_exp(delta):
    """(...,6) tangent [v, w] -> (...,4,4) homogeneous transform."""
    v, w = delta[..., :3], delta[..., 3:]
    theta2 = torch.sum(w * w, -1)
    R = so3_exp(w)
    a, b = _left_jacobian_coeffs(theta2)
    W = so3_hat(w)
    V = _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)
    t = (V @ v[..., None])[..., 0]
    return _homogeneous(R, t)


def se3_log(T):
    """(...,4,4) -> (...,6) tangent [v, w]; inverse of se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, -1)
    theta, small, safe2 = _taylor_safe(theta2)
    W = so3_hat(w)
    sin_t = torch.sin(theta)
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / safe2) - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.where(small, torch.ones_like(sin_t), sin_t)),
    )
    Vinv = _eye3(w) - 0.5 * W + c[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)


def se3_identity(dtype=torch.float32, batch=(), device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch) + (4, 4))


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ t[..., None])[..., 0])


def se3_compose(A, B):
    return A @ B


def se3_apply(T, pts):
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def se3_adjoint(T):
    """(...,4,4) -> (...,6,6) adjoint for the [v, w] tangent ordering."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = so3_hat(t) @ R
    top = torch.cat([R, tR], -1)
    bottom = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bottom], -2)
