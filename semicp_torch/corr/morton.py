"""Morton (Z-order) codes and tile bounding boxes in PyTorch.

Port of `semicp/corr/morton.py`: the same int32 bit arithmetic, so the
codes (and hence the class-major Morton permutation) equal the JAX
package's exactly. Locality comes from the data layout; exactness of
the tile pruning rests on the per-tile AABBs, never on the codes.
"""

from __future__ import annotations

import torch

# 10 bits per axis -> 30-bit codes; the invalid sentinel uses bit 30 and
# sorts after every real code.
_BITS = 10
INVALID_CODE = 1 << (3 * _BITS)


def _spread3(v):
    """Spread 10 bits of v so there are two zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(xyz, valid, cell: float):
    """(3, N) planes + (N,) valid -> (N,) int32 Z-order codes."""
    lo = torch.amin(xyz.masked_fill(~valid[None, :], float("inf")), dim=1)   # (3,)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    # .to(int32) truncates toward zero like astype; then clip
    q = torch.clamp(((xyz - lo[:, None]) / cell).to(torch.int32), 0, (1 << _BITS) - 1)
    code = _spread3(q[0]) | (_spread3(q[1]) << 1) | (_spread3(q[2]) << 2)
    return torch.where(valid, code, torch.full_like(code, INVALID_CODE))


def morton_order(xyz, valid, cell: float):
    """Permutation sorting points by Morton code, invalid last; equal codes
    keep their input order (a stable sort, as jnp.argsort's)."""
    return torch.argsort(morton_codes(xyz, valid, cell), stable=True)


def tile_aabbs(xyz, valid, tile: int):
    """Per-tile AABBs over VALID points: (3, N) -> (n_tiles, 3) lo and hi.

    All-invalid tiles get lo=+inf / hi=-inf (pruned against any gate).
    """
    n = xyz.shape[1]
    x = xyz.reshape(3, n // tile, tile)
    v = valid.reshape(1, n // tile, tile)
    lo = torch.amin(x.masked_fill(~v, float("inf")), dim=2).T
    hi = torch.amax(x.masked_fill(~v, float("-inf")), dim=2).T
    return lo, hi


def box_dist2(qlo, qhi, tlo, thi):
    """Squared distance between AABB sets: (Q,3)x(T,3) -> (Q,T).

    Zero where boxes overlap; a lower bound on the distance between any
    pair of points drawn from the two boxes (the pruning invariant).
    """
    d = torch.clamp(torch.maximum(qlo[:, None, :] - thi[None, :, :],
                                  tlo[None, :, :] - qhi[:, None, :]), min=0.0)
    d = torch.nan_to_num(d, nan=1.0e18)        # inf-inf from empty boxes
    d = torch.clamp(d, max=1.0e18)             # keep d^2 finite in f32
    return torch.sum(d * d, dim=-1)
