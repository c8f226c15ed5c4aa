"""Planar symmetric-3x3 algebra: component planes, not (...,3,3) tensors.

Port of `semicp/geom/sym3.py`. A symmetric 3x3 field over N points is
six (N,)-shaped planes in the order (xx, yy, zz, xy, xz, yz); a point
field is three. The planar layout is kept so that the port's arrays
compare one to one with the JAX package's, and every function is the
same closed-form elementwise math.
"""

from __future__ import annotations

import math

import torch

XX, YY, ZZ, XY, XZ, YZ = range(6)


def from_matrix(M):
    """(...,3,3) symmetric -> 6-tuple of (...,) planes."""
    return (M[..., 0, 0], M[..., 1, 1], M[..., 2, 2],
            M[..., 0, 1], M[..., 0, 2], M[..., 1, 2])


def to_matrix(c):
    """6-tuple -> (...,3,3)."""
    xx, yy, zz, xy, xz, yz = c
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def identity_like(x, scale=1.0):
    one = torch.full_like(x, scale)
    zero = torch.zeros_like(x)
    return (one, one, one, zero, zero, zero)


def add(a, b):
    return tuple(ai + bi for ai, bi in zip(a, b))


def scale(a, s):
    return tuple(ai * s for ai in a)


def matvec(c, v):
    """Symmetric matrix-vector product on planes: returns (3,) vec planes."""
    xx, yy, zz, xy, xz, yz = c
    vx, vy, vz = v
    return (xx * vx + xy * vy + xz * vz,
            xy * vx + yy * vy + yz * vz,
            xz * vx + yz * vy + zz * vz)


def rotate(R, c):
    """R C R^T for one (3,3) rotation R and planar sym C."""
    xx, yy, zz, xy, xz, yz = c

    def row(a):
        r0, r1, r2 = R[a, 0], R[a, 1], R[a, 2]
        return (xx * r0 + xy * r1 + xz * r2,
                xy * r0 + yy * r1 + yz * r2,
                xz * r0 + yz * r1 + zz * r2)

    a0, a1, a2 = row(0), row(1), row(2)

    def dot(av, b):
        return av[0] * R[b, 0] + av[1] * R[b, 1] + av[2] * R[b, 2]

    return (dot(a0, 0), dot(a1, 1), dot(a2, 2), dot(a0, 1), dot(a0, 2), dot(a1, 2))


def det(c):
    xx, yy, zz, xy, xz, yz = c
    return (xx * (yy * zz - yz * yz)
            - xy * (xy * zz - yz * xz)
            + xz * (xy * yz - yy * xz))


def inv(c, det_c=None):
    """Closed-form symmetric inverse via adjugate; returns planar sym."""
    xx, yy, zz, xy, xz, yz = c
    rd = 1.0 / (det(c) if det_c is None else det_c)
    return ((yy * zz - yz * yz) * rd,
            (xx * zz - xz * xz) * rd,
            (xx * yy - xy * xy) * rd,
            (xz * yz - xy * zz) * rd,
            (xy * yz - xz * yy) * rd,
            (xy * xz - xx * yz) * rd)


def chol(c, jitter=0.0):
    """Closed-form lower Cholesky; returns (l00,l10,l11,l20,l21,l22) planes."""
    xx, yy, zz, xy, xz, yz = c
    l00 = torch.sqrt(torch.clamp(xx + jitter, min=1e-30))
    l10 = xy / l00
    l20 = xz / l00
    l11 = torch.sqrt(torch.clamp(yy + jitter - l10 * l10, min=1e-30))
    l21 = (yz - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(zz + jitter - l20 * l20 - l21 * l21, min=1e-30))
    return (l00, l10, l11, l20, l21, l22)


def chol_logdet(L):
    l00, _, l11, _, _, l22 = L
    return 2.0 * (torch.log(l00) + torch.log(l11) + torch.log(l22))


def chol_maha(L, v):
    """v^T (L L^T)^{-1} v via forward substitution on planes."""
    l00, l10, l11, l20, l21, l22 = L
    vx, vy, vz = v
    e0 = vx / l00
    e1 = (vy - l10 * e0) / l11
    e2 = (vz - l20 * e0 - l21 * e1) / l22
    return e0 * e0 + e1 * e1 + e2 * e2


def eigvals(c):
    """Eigenvalues (descending 3-tuple of planes) — trigonometric method."""
    xx, yy, zz, xy, xz, yz = c
    p1 = xy * xy + xz * xz + yz * yz
    q = (xx + yy + zz) / 3.0
    b00, b11, b22 = xx - q, yy - q, zz - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detb = (b00 * (b11 * b22 - yz * yz)
            - xy * (xy * b22 - yz * xz)
            + xz * (xy * yz - b11 * xz))
    # p^3 underflows f32 to 0 for isotropic matrices (p is clipped to
    # ~1e-15): clamp the denominator so 0/0 never produces a NaN, exactly
    # as the JAX module does.
    r = torch.clamp(detb / torch.clamp(2.0 * p * p * p, min=1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    near_diag = p1 < 1e-12 * (q * q + 1e-30)
    dmax = torch.maximum(torch.maximum(xx, yy), zz)
    dmin = torch.minimum(torch.minimum(xx, yy), zz)
    dmid = xx + yy + zz - dmax - dmin
    return (torch.where(near_diag, dmax, e1),
            torch.where(near_diag, dmid, e2),
            torch.where(near_diag, dmin, e3))


def smallest_eigvec(c):
    """Unit eigenvector planes (nx,ny,nz) for the smallest eigenvalue.

    Cross-product method on rows of (C - lam_min I); the largest of the
    three candidate cross products wins; isotropic fallback +z.
    """
    lam = eigvals(c)[2]
    xx, yy, zz, xy, xz, yz = c
    m00, m11, m22 = xx - lam, yy - lam, zz - lam
    c0 = (xy * yz - xz * m11, xz * xy - m00 * yz, m00 * m11 - xy * xy)
    c1 = (xy * m22 - xz * yz, xz * xz - m00 * m22, m00 * yz - xy * xz)
    c2 = (m11 * m22 - yz * yz, yz * xz - xy * m22, xy * yz - m11 * xz)
    n0 = c0[0] ** 2 + c0[1] ** 2 + c0[2] ** 2
    n1 = c1[0] ** 2 + c1[1] ** 2 + c1[2] ** 2
    n2 = c2[0] ** 2 + c2[1] ** 2 + c2[2] ** 2
    use1 = n1 > n0
    bx = torch.where(use1, c1[0], c0[0])
    by = torch.where(use1, c1[1], c0[1])
    bz = torch.where(use1, c1[2], c0[2])
    bn = torch.where(use1, n1, n0)
    use2 = n2 > bn
    bx = torch.where(use2, c2[0], bx)
    by = torch.where(use2, c2[1], by)
    bz = torch.where(use2, c2[2], bz)
    bn = torch.where(use2, n2, bn)
    ok = bn > 1e-24
    rn = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, bn, torch.ones_like(bn))),
                     torch.zeros_like(bn))
    return (bx * rn, by * rn, torch.where(ok, bz * rn, torch.ones_like(bz)))


def regularize_gicp(c, eps):
    """GICP clamp on planes: C -> I - (1-eps) n n^T."""
    nx, ny, nz = smallest_eigvec(c)
    k = 1.0 - eps
    one = torch.ones_like(nx)
    return (one - k * nx * nx, one - k * ny * ny, one - k * nz * nz,
            -k * nx * ny, -k * nx * nz, -k * ny * nz)


def pack(c):
    """6-tuple of (...,) planes -> (6, ...) tensor."""
    return torch.stack(c, 0)


def unpack(a):
    """(6, ...) tensor -> 6-tuple of planes."""
    return tuple(a[i] for i in range(6))
