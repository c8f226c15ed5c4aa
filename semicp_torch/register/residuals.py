"""GICP log-likelihood and the SE(3) normal equations on planes.

Port of `semicp/register/residuals.py`. `normal_equations_planar` takes
per-correspondence weights, Sigma^-1 planes and residuals. The EM loop
uses `normal_equations_collapsed`: with the E-step's per-point planes
A_i = sum_k w Sigma^-1, b_i = sum_k w Sigma^-1 x and c_i = sum_k w
x^T Sigma^-1 x, and J_i = [-I | hat(p_i)] for the moved source point
p_i = T z_i, the Gauss-Newton system is

    H = sum_i J_i^T A_i J_i,  g = sum_i J_i^T (b_i - A_i p_i),
    cost = sum_i c_i - 2 b_i.p_i + p_i.A_i p_i.

The per-point terms are stacked into one (28, N) tensor and summed in
one reduction, so a GN pass costs one reduction launch, not 28.
"""

from __future__ import annotations

import functools
import math

import torch

from semicp_torch.geom import sym3

_LOG_2PI_3 = 3.0 * math.log(2.0 * math.pi)

# Layout of the 28 sums: a00 a11 a22 a01 a02 a12 | b00..b22 (row-major) |
# c00 c01 c02 c11 c12 c22 | u0 u1 u2 | (u x p)0..2 | cost.
# H = [[A, -B], [-B^T, C]] with A, C symmetric; g = [-u, u x p].
_H_INDEX = torch.tensor([
    [0, 3, 4, 6, 7, 8],
    [3, 1, 5, 9, 10, 11],
    [4, 5, 2, 12, 13, 14],
    [6, 9, 12, 15, 16, 17],
    [7, 10, 13, 16, 18, 19],
    [8, 11, 14, 17, 19, 20],
])
_H_SIGN = torch.tensor([
    [1.0, 1.0, 1.0, -1.0, -1.0, -1.0],
    [1.0, 1.0, 1.0, -1.0, -1.0, -1.0],
    [1.0, 1.0, 1.0, -1.0, -1.0, -1.0],
    [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0],
    [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0],
    [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0],
])
_G_SIGN = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype):
    """The H/g assembly tables on `device`, copied there once (a host
    copy blocks until the device is idle, so never inside the GN loop)."""
    return _H_INDEX.to(device), _H_SIGN.to(device, dtype), _G_SIGN.to(device, dtype)


def gaussian_loglik_planar(sigma, d):
    """log N(d; 0, Sigma) on planes: sigma 6-tuple, d 3-tuple of planes."""
    L = sym3.chol(sigma)
    return -0.5 * (sym3.chol_maha(L, d) + sym3.chol_logdet(L) + _LOG_2PI_3)


def _system_terms(a6, p, t):
    """The 27 per-point terms of H and g for the planes of a symmetric A
    (sym3 order), the moved points p and u = t (layout of `_H_INDEX`)."""
    a00, a11, a22, a01, a02, a12 = a6
    px, py, pz = p
    t0, t1, t2 = t
    # B = A P, P = hat(p)
    b00 = a01 * pz - a02 * py
    b01 = -a00 * pz + a02 * px
    b02 = a00 * py - a01 * px
    b10 = a11 * pz - a12 * py
    b11 = -a01 * pz + a12 * px
    b12 = a01 * py - a11 * px
    b20 = a12 * pz - a22 * py
    b21 = -a02 * pz + a22 * px
    b22 = a02 * py - a12 * px
    # C = P^T A P = -P B (symmetric)
    c00 = pz * b10 - py * b20
    c01 = pz * b11 - py * b21
    c02 = pz * b12 - py * b22
    c11 = -pz * b01 + px * b21
    c12 = -pz * b02 + px * b22
    c22 = py * b02 - px * b12
    return [a00, a11, a22, a01, a02, a12,
            b00, b01, b02, b10, b11, b12, b20, b21, b22,
            c00, c01, c02, c11, c12, c22,
            t0, t1, t2,
            t1 * pz - t2 * py, t2 * px - t0 * pz, t0 * py - t1 * px]


def _assemble(terms):
    """Sum the 28 stacked per-point terms (27 + cost) into (H, g, cost)."""
    s = terms.reshape(28, -1).sum(dim=1)                        # (28,)
    h_index, h_sign, g_sign = _tables(s.device, s.dtype)
    return s[h_index] * h_sign, s[21:27] * g_sign, s[27]


def normal_equations_planar(w, sinv, p, d):
    """GN system (H (6,6), g (6,), cost ()) from per-correspondence planes.

    w: (...,) weights; sinv: 6-tuple of Sigma^-1 planes (sym3 order);
    p: 3-tuple of moved source points T z; d: 3-tuple of residuals x - T z.
    With P = hat(p) and J = [-I | P]: H = sum w J^T S J, g = sum w J^T S d,
    cost = sum w d^T S d, all summed over every dim.
    """
    s00, s11, s22, s01, s02, s12 = sinv
    dx, dy, dz = d
    t = (s00 * dx + s01 * dy + s02 * dz,          # S d
         s01 * dx + s11 * dy + s12 * dz,
         s02 * dx + s12 * dy + s22 * dz)
    cost = dx * t[0] + dy * t[1] + dz * t[2]
    return _assemble(w * torch.stack(_system_terms(sinv, p, t) + [cost]))


def normal_equations_collapsed(a6, b3, c, p):
    """GN system (H (6,6), g (6,), cost ()) from class-collapsed planes.

    a6: 6 planes (sym3 order) or a (6, N) tensor; b3: 3 planes; c (N,);
    p: 3 planes of the moved source points.
    """
    a00, a11, a22, a01, a02, a12 = a6
    bx, by, bz = b3
    px, py, pz = p
    ap0 = a00 * px + a01 * py + a02 * pz          # A p
    ap1 = a01 * px + a11 * py + a12 * pz
    ap2 = a02 * px + a12 * py + a22 * pz
    t = (bx - ap0, by - ap1, bz - ap2)            # u = b - A p
    cost = c - 2.0 * (bx * px + by * py + bz * pz) + px * ap0 + py * ap1 + pz * ap2
    return _assemble(torch.stack(_system_terms(a6, p, t) + [cost]))
