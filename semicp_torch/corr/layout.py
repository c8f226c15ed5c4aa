"""Canonical cloud layout: class-major + Morton-within-class sort.

Port of `semicp/corr/layout.py`. Sorting points by (class, Morton code),
invalid last, makes every fixed-size tile of the array cover a compact
region of (usually) one class, so per-tile AABBs and class ranges prune
whole tiles for the neighbourhood-moments and nearest-neighbour kernels.
The sort happens once per cloud at preprocess time and is recorded in
`Cloud.layout == "cm"`.

The JAX package sorts with a two-key `lax.sort` because a TPU has no
int64. Here one stable sort on the int64 key `(cls << 31) | code` gives
exactly the same permutation: the code occupies bits 0-30 (the invalid
sentinel is bit 30), so shifting the class by 31 keeps the keys ordered
lexicographically, and a stable sort breaks full-key ties by index as
the stable two-key sort does.
"""

from __future__ import annotations

import torch

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.corr.morton import box_dist2, morton_codes, tile_aabbs

LAYOUT_CM = "cm"  # class-major, Morton-within-class, invalid last


def class_morton_order(xyz, label, valid, num_classes: int, cell: float):
    """Permutation sorting by (class, Morton), invalid last (class = K)."""
    code = morton_codes(xyz, valid, cell)
    cls = torch.where(valid, torch.clamp(label, min=0), torch.full_like(label, num_classes))
    key = (cls.to(torch.int64) << 31) | code.to(torch.int64)
    return torch.sort(key, stable=True).indices


def sort_cloud_cm(cloud: Cloud, num_classes: int, cell: float) -> Cloud:
    """Return the cloud in canonical class-major Morton order."""
    order = class_morton_order(cloud.xyz, cloud.label, cloud.valid, num_classes, cell)
    return cloud.replace(
        xyz=cloud.xyz[:, order],
        label=cloud.label[order],
        cov6=cloud.cov6[:, order],
        valid=cloud.valid[order],
        layout=LAYOUT_CM,
    )


def tile_meta(xyz, label, valid, num_classes: int, tile: int) -> dict:
    """Per-tile metadata over a cm-sorted cloud.

    lo/hi (n_t, 3) exact AABBs over valid points and cmin/cmax (n_t,)
    int32 class ranges (cmin > cmax for all-invalid tiles).
    """
    n = xyz.shape[1]
    if n % tile:
        raise ValueError(f"tile_meta: N={n} must be a multiple of the tile size {tile}")
    lo, hi = tile_aabbs(xyz, valid, tile)
    lab = torch.where(valid, torch.clamp(label, min=0), torch.full_like(label, -1)).reshape(-1, tile)
    cmax = torch.amax(lab, dim=1).to(torch.int32)
    cmin = torch.amin(torch.where(lab >= 0, lab, torch.full_like(lab, num_classes)),
                      dim=1).to(torch.int32)
    return {"lo": lo, "hi": hi, "cmin": cmin, "cmax": cmax}


def tile_candidates(qlo, qhi, tlo, thi, gate, q_range=None, t_range=None):
    """Per-query-tile candidate target-tile lists under a distance gate.

    box_dist2 lower-bounds every point-pair distance between two tiles,
    so a tile beyond the gate holds no correspondence the caller would
    accept. `gate` may be a float or a 0-dim tensor (no host sync).
    q_range/t_range: optional (cmin, cmax) pairs; tiles whose class
    ranges do not overlap the query tile's are pruned as well.

    Candidates are ordered nearest-box-first (stable on ties), and the
    lists are uncapped. Returns (cand (n_qt, n_tt) int32 — real
    candidates first, the tail repeating the last real one — and
    count (n_qt,) int32).
    """
    bd2 = box_dist2(qlo, qhi, tlo, thi)                      # (n_qt, n_tt)
    gate2 = gate * gate * (1.0 + 1e-5) + 1e-6
    mask = bd2 <= gate2
    if q_range is not None and t_range is not None:
        qmin, qmax = q_range
        tmin, tmax = t_range
        mask = mask & (qmin[:, None] <= tmax[None, :]) & (tmin[None, :] <= qmax[:, None])
    count = torch.sum(mask, dim=1).to(torch.int32)
    key = torch.where(mask, bd2, torch.full_like(bd2, float("inf")))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    last = torch.gather(order, 1, torch.clamp(count.long() - 1, min=0)[:, None])
    cols = torch.arange(order.shape[1], dtype=torch.int32, device=order.device)
    cand = torch.where(cols[None, :] < count[:, None], order, last)
    return cand, count
