"""Closed-form symmetric 3x3 eigendecomposition and Cholesky, batched.

Port of `semicp/geom/eig3.py`: the same branchless closed forms over
(...,3,3) tensors (the trigonometric eigenvalues, cross-product
eigenvectors, a closed-form Cholesky and its triangular solves), with the
same floors and fallbacks, so an exactly-zero matrix stays finite.

The GICP clamp C_reg = R diag(1, 1, eps) R^T depends only on the
smallest-eigenvalue eigenvector n (the surface normal):
C_reg = I - (1 - eps) n n^T, which is what `gicp_regularize` computes.
"""

from __future__ import annotations

import math

import torch


def _sym_parts(A):
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    return a00, a01, a02, a11, a12, a22


def eigvals3x3(A):
    """Eigenvalues of symmetric (...,3,3), descending — trigonometric method."""
    a00, a01, a02, a11, a12, a22 = _sym_parts(A)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    # the 1e-20 floor keeps p^3 a normal f32, so an exactly-zero matrix
    # never reaches 0/0 below
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-20))
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / torch.clamp(2.0 * p * p * p, min=1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    # diagonal / near-spherical guard: p1 ~ 0 means A is (almost) diagonal
    dsort = torch.flip(torch.sort(torch.stack([a00, a11, a22], -1), dim=-1).values, [-1])
    near_diag = (p1 < 1e-12 * (q * q + 1e-12))[..., None]
    return torch.where(near_diag, dsort, torch.stack([e1, e2, e3], -1))


def _eigvec_for(A, lam, fallback):
    """Unit eigenvector of symmetric A for a well-separated eigenvalue lam.

    Rows of (A - lam I) are orthogonal to the eigenvector: the largest of
    their three pairwise cross products wins; `fallback` where all vanish.
    """
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                         torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], -2)
    n2 = torch.sum(cands * cands, -1)
    best = torch.argmax(n2, -1)                       # first maximum, as jnp
    v = torch.take_along_dim(cands, best[..., None, None].expand(best.shape + (1, 3)),
                             dim=-2)[..., 0, :]
    vn2 = torch.sum(v * v, -1, keepdim=True)
    ok = vn2 > 1e-24
    return torch.where(ok, v / torch.sqrt(torch.where(ok, vn2, torch.ones_like(vn2))), fallback)


def _axis(A, k):
    """Unit vector e_k broadcast to A's batch shape (...,3)."""
    e = torch.zeros(3, dtype=A.dtype, device=A.device)
    e[k] = 1.0
    return e.expand(A.shape[:-1])


def smallest_eigvec(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric (...,3,3).

    The GICP surface normal; a spherical neighbourhood falls back to +z.
    """
    return _eigvec_for(A, eigvals3x3(A)[..., 2], _axis(A, 2))


def eigh3x3(A):
    """Full decomposition of symmetric (...,3,3): (eigvals desc, eigvecs cols).

    Returns (w, V) with w[...,k] descending and V[...,:,k] the matching
    unit eigenvectors, a right-handed orthonormal basis: the two extreme
    eigenvectors, re-orthogonalized, and their cross product.
    """
    w = eigvals3x3(A)
    fb1, fb3 = _axis(A, 0), _axis(A, 2)
    v1 = _eigvec_for(A, w[..., 0], fb1)
    v3 = _eigvec_for(A, w[..., 2], fb3)
    v3 = v3 - torch.sum(v3 * v1, -1, keepdim=True) * v1
    n3 = torch.linalg.vector_norm(v3, dim=-1, keepdim=True)
    v3 = torch.where(n3 > 1e-12, v3 / torch.clamp(n3, min=1e-12),
                     fb3 - torch.sum(fb3 * v1, -1, keepdim=True) * v1)
    v3 = v3 / torch.linalg.vector_norm(v3, dim=-1, keepdim=True)
    v2 = torch.linalg.cross(v3, v1, dim=-1)
    return w, torch.stack([v1, v2, v3], -1)


def gicp_regularize(C, eps):
    """GICP plane-to-plane clamp: C -> R diag(1,1,eps) R^T == I - (1-eps) n n^T."""
    n = smallest_eigvec(C)
    eye = torch.eye(3, dtype=C.dtype, device=C.device).expand(C.shape)
    return eye - (1.0 - eps) * n[..., :, None] * n[..., None, :]


def cholesky3x3(A, jitter=0.0):
    """Closed-form lower Cholesky of SPD (...,3,3) (+ optional diagonal jitter)."""
    a00, a01, a02, a11, a12, a22 = _sym_parts(A)
    a00, a11, a22 = a00 + jitter, a11 + jitter, a22 + jitter
    l00 = torch.sqrt(torch.clamp(a00, min=1e-30))
    l10 = a01 / l00
    l20 = a02 / l00
    l11 = torch.sqrt(torch.clamp(a11 - l10 * l10, min=1e-30))
    l21 = (a12 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(a22 - l20 * l20 - l21 * l21, min=1e-30))
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z, z], -1),
                        torch.stack([l10, l11, z], -1),
                        torch.stack([l20, l21, l22], -1)], -2)


def tri_solve3x3(L, b):
    """Forward-substitution solve L y = b for lower-triangular (...,3,3), b (...,3)."""
    y0 = b[..., 0] / L[..., 0, 0]
    y1 = (b[..., 1] - L[..., 1, 0] * y0) / L[..., 1, 1]
    y2 = (b[..., 2] - L[..., 2, 0] * y0 - L[..., 2, 1] * y1) / L[..., 2, 2]
    return torch.stack([y0, y1, y2], -1)


def tri_solve3x3_mat(L, B):
    """Solve L Y = B for (...,3,3) B column-wise (whitening a Jacobian block)."""
    return torch.stack([tri_solve3x3(L, B[..., :, k]) for k in range(3)], -1)


def cho_solve3x3(L, b):
    """Solve (L L^T) x = b."""
    y = tri_solve3x3(L, b)
    x2 = y[..., 2] / L[..., 2, 2]
    x1 = (y[..., 1] - L[..., 2, 1] * x2) / L[..., 1, 1]
    x0 = (y[..., 0] - L[..., 1, 0] * x1 - L[..., 2, 0] * x2) / L[..., 0, 0]
    return torch.stack([x0, x1, x2], -1)
